"""``ssd_scan``: one chunked SSD scan of a sequence of T tokens for one
slot, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T and y_t = h_t C_t + D x_t
per head, from the slot's carried state.

Operations: what the recurrence needs, 2 FLOPs a state element for its
update and 2 for its read-out, per token: 4 T H P N. The chunked form
that a kernel computes (within-chunk scores, chunk states, state passing)
does more than this, and reads a lower share; no exact scan does less.

Bytes: x [T, H, P], dt [T, H], B and C [T, N] read once and y [T, H, P]
written once, f32, and the final state [H, P, N] f32 written once. The
carried state's read is left out (a prompt's first chunk has none), as is
the kernel's workspace: the bound is a floor.
"""


def count(tokens: int, heads: int, head_dim: int, d_state: int):
    """(FLOPs, bytes) of one call."""
    flops = 4.0 * tokens * heads * head_dim * d_state
    n_bytes = 4.0 * (2 * tokens * heads * head_dim + tokens * heads
                     + 2 * tokens * d_state
                     + heads * head_dim * d_state)
    return flops, n_bytes
