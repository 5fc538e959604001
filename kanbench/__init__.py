"""The benchmark of the PyTorch and CUDA port (``repro_torch``): CF-KAN
scored offline on the fused kernel and evaluated on the simulated ACIM
crossbar and chip. See ``kanbench/README.md``."""
