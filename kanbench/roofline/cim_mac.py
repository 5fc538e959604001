"""``cim_mac``: the bit-sliced crossbar MAC of one monolithic array per As
rows (``cim_mac_tiled``, a grid of As-row tiles with a per-cell gain, is
counted the same way, with its gains):
for each array, bit plane and column, the sum of the live word lines'
attenuated values, each times the sign (and gain) of its cell where the
plane's bit is set, read by the ADC.

Operations: one multiply-add (2 FLOPs) per live (batch row, word line)
pair, column and bit plane, and one conversion (1 FLOP) per ADC readout
(batch row, array, column, bit plane). A live pair is one whose attenuated
word-line value is not zero; a pair that is zero adds nothing, however a
kernel handles it.

The card's peak (``peaks.py``) is its bf16 tensor-core rate. The ADC reads
an in-order f32 sum that no tensor-core product forms, so an exact kernel
runs on the CUDA cores, under 67 TFLOP/s: against 989 TFLOP/s its share
reads up to 15 times low, and can never pass 100%, however few of the
planes' adds a kernel skips.

Bytes: the word-line values [B, R] f32 read once, the int8 codes [R, C],
the row attenuation [R] f32, the gains [R, C] f32 (tiles only), and the
output [B, C] (f32 or int32) written once. R and C are the layer's own rows
and columns, not a layout's padding.
"""


def count(batch: int, rows: int, cols: int, live_pairs: int,
          array_size: int, gains: bool = False):
    """(FLOPs, bytes) of one call."""
    arrays = -(-rows // array_size)
    flops = 2.0 * live_pairs * cols * 8 + 1.0 * batch * arrays * cols * 8
    n_bytes = (4.0 * batch * rows + rows * cols + 4.0 * rows
               + (4.0 * rows * cols if gains else 0.0) + 4.0 * batch * cols)
    return flops, n_bytes
