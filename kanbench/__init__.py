"""The benchmark of the PyTorch and CUDA port (``repro_torch``): CF-KAN
scored offline on the fused kernel, online under an open loop, and
evaluated on the simulated ACIM crossbar and chip; and the port's LM
serving engine. See ``kanbench/README.md``."""
import sys
from typing import List

# modules that no run may load: JAX and the JAX package this port mirrors
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})
