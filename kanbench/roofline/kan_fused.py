"""``kan_fused``: one deployed KAN layer, y = (E @ codes) * scale, with the
quantised basis E formed on the fly.

Operations: one multiply-add (2 FLOPs) per nonzero basis entry of the
inputs and output channel, and the epilogue's multiply by the scale per
output. This is what the layer's arithmetic needs, counted from the data:
a kernel that splits each tap into bf16 parts (three products where one
would do) or that forms the zero entries does more work than this, and
reads a lower share; none can do less.

Bytes: the inputs x [B, I] f32 read once, the int8 codes [I, S, O] once,
the scales [O] f32, and y [B, O] f32 written once (the tap table, a few
hundred bytes, is left out).
"""


def count(batch: int, n_in: int, n_basis: int, n_out: int,
          nonzero_taps: int):
    """(FLOPs, bytes) of one call."""
    flops = 2.0 * nonzero_taps * n_out + batch * n_out
    n_bytes = (4.0 * batch * n_in + n_in * n_basis * n_out + 4.0 * n_out
               + 4.0 * batch * n_out)
    return flops, n_bytes
