from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, QTensor, adamw, adafactor, clip_by_global_norm, global_norm,
    warmup_cosine, make_optimizer)
