"""The exact three-way bf16 split of the SH-LUT taps that the ``kan_fused``
kernel feeds to the tensor cores: hi = bf16(t), mid = bf16(t - hi),
lo = t - hi - mid, with round-to-nearest casts and f32 subtractions as the
kernel computes them. For every SH-LUT the configs and the kernel tests use
(G in {5, 7, 8, 16, 64}, K in {2, 3}, 8-bit inputs), lo is exact in bf16 and
hi + mid + lo is the tap exactly, so every product of a piece with an int8
code (exact in bf16) is exact. The SH-LUT itself is the JAX package's, bit
for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import quant as jq  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from test_torch_attention import _one_torch_thread  # noqa: E402,F401


def _split(t):
    hi = t.to(torch.bfloat16)
    r1 = t - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo_f32 = r1 - mid.to(torch.float32)
    return hi, mid, lo_f32


@pytest.mark.parametrize("k", (2, 3))
@pytest.mark.parametrize("g", (5, 7, 8, 16, 64))
def test_sh_lut_splits_exactly_into_three_bf16(g, k):
    cfg = tq.ASPConfig(grid_size=g, order=k, n_bits=8)
    hemi = tq.hemi_for(cfg, "cpu")
    np.testing.assert_array_equal(
        hemi.numpy(), np.asarray(jq.hemi_for(jq.ASPConfig(
            grid_size=g, order=k, n_bits=8))))
    assert hemi.shape == ((cfg.levels_per_interval + 1) // 2, k + 1)
    assert bool((hemi > 0).all())          # normal f32: no subnormal piece
    hi, mid, lo_f32 = _split(hemi)
    lo = lo_f32.to(torch.bfloat16)
    # each piece is a bf16 value, lo included
    assert torch.equal(lo.to(torch.float32), lo_f32)
    # and the three add back to the tap exactly
    total = (hi.to(torch.float64) + mid.to(torch.float64)
             + lo.to(torch.float64))
    assert torch.equal(total, hemi.to(torch.float64))
    # every product with an int8 code is exact in f32, as on the tensor cores
    codes = torch.arange(-128, 128, dtype=torch.float32)
    for piece in (hi, mid, lo):
        p32 = piece.to(torch.float32).reshape(-1, 1) * codes
        p64 = piece.to(torch.float64).reshape(-1, 1) * codes.double()
        assert torch.equal(p32.double(), p64)
