"""``cim_mac_tiled``: the chip's multi-tile MAC, counted as ``cim_mac``
is, with the per-cell gains of a chip with variation (an ideal chip has
none)."""
from kanbench.roofline import cim_mac


def count(batch: int, rows: int, cols: int, live_pairs: int,
          array_size: int, gains: bool):
    """(FLOPs, bytes) of one call."""
    return cim_mac.count(batch, rows, cols, live_pairs, array_size, gains)
