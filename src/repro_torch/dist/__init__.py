"""repro_torch.dist: preemption and straggler handling (``fault``). The
reference's sharding rules and compressed all-reduce are ROADMAP Slice F."""
