"""Chunked Mamba-2 SSD scan: the wrapper of the hand-written CUDA kernel
``csrc/ssd_scan.cu`` (port of the TPU kernel ``repro.kernels.ssd_scan``).

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t ;   y_t = C_t . h_t + D x_t

per head, in chunks. The kernel is chunk-parallel: C B^T per (batch,
chunk); each chunk's own state contribution on the tensor cores; the
chunk-to-chunk recurrence, elementwise over [P, N]; then every chunk's
output on the tensor cores, from the state entering it. Its products run in
3xTF32 (each f32 operand split into two tf32 pieces, three products).
Unlike the TPU kernel it also takes an initial state and returns the final
one, which the serving prefill needs. Its plain versions are
``kernels.ref.ssd_chunked_ref`` (the same chunked form) and
``kernels.ref.ssd_ref`` (the sequential recurrence); ``kernels.ops`` picks
between kernel and plain version by the device of the input.

``ssd_scan_mirror`` repeats the kernel's decomposition and, with
``split=True``, its 3xTF32 arithmetic in plain PyTorch, for the tests: it
is a rehearsal of the kernel's numbers on the CPU, on no serving path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_SMEM = 232_448   # bytes of shared memory a block may use on Hopper
P_ALIGN = 8          # P in whole n8 tiles of the tensor-core product


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Shared memory of one block of either tensor-core kernel (the two
    come to the same): the chunk scan's three raw 64 x 36 A tiles and two
    {big, small} B tiles of 2304 float2s, or the chunk state's three raw
    16 x 72 x tiles and split 16 x 132 B tiles; and the chunk's two rows
    (cs and dt, or dt and decays). Neither depends on P or N, which the
    grid tiles."""
    del p, n
    return 4 * (3 * 64 * 36 + 2 * chunk) + 8 * 2 * 2304


def supported(p: int, n: int, chunk: int) -> bool:
    return (p >= P_ALIGN and p % P_ALIGN == 0 and n >= 1 and chunk >= 1
            and smem_bytes(p, n, chunk) <= MAX_SMEM)


def workspace_floats(bsz: int, t: int, h: int, p: int, n: int,
                     chunk: int) -> int:
    """f32 elements of the kernel's workspace (``csrc/ssd_scan.cu::
    workspace_floats``, which checks it): scores [B, nc, cl, round4(cl)], chunk states
    [B, H, nc, P, round4(N)], cs [B, H, nc, cl] and decays [B, H, nc], each
    region rounded up to 4 elements, then B split into {big, small} pairs,
    [B, T, round4(N)] x 2."""
    nc = -(-t // chunk)
    return (_round4(bsz * nc * chunk * _round4(chunk))
            + _round4(bsz * h * nc * p * _round4(n))
            + _round4(bsz * h * nc * chunk) + _round4(bsz * h * nc)
            + 2 * bsz * t * _round4(n))


def _rows(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as given if its last dim is contiguous (the kernel takes the
    outer strides), else a contiguous copy."""
    if t.dtype != torch.float32:
        raise ValueError(f"ssd_scan: {what} must be f32, got {t.dtype}")
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor,
             d_skip: Optional[torch.Tensor], *, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on f32 CUDA tensors: x [B, T, H, P], dt [B, T, H],
    a [H], b_mat/c_mat [B, T, N], d_skip [H] or None, init_state [B, H, P,
    N] or None. ``x``, ``dt``, ``b_mat`` and ``c_mat`` may be views with
    outer strides (slices of the mixer's projection are read in place).
    T need not be a multiple of ``chunk``. Returns (y [B, T, H, P],
    final_state [B, H, P, N]). Counts each call in ``ssd_scan.launches``
    (one call launches the kernel's five CUDA kernels), and a call with
    ``init_state`` (a chunked prefill's carried state) also in
    ``ssd_scan.init_launches``."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    if (dt.shape != (bsz, t, h) or a.shape != (h,)
            or b_mat.shape != (bsz, t, n) or c_mat.shape != (bsz, t, n)
            or (d_skip is not None and d_skip.shape != (h,))
            or (init_state is not None
                and init_state.shape != (bsz, h, p, n))):
        raise ValueError("ssd_scan: shapes do not fit x "
                         f"{tuple(x.shape)}: dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, B {tuple(b_mat.shape)}, C "
                         f"{tuple(c_mat.shape)}")
    if not supported(p, n, chunk):
        raise ValueError(f"ssd_scan: P={p}, N={n}, chunk={chunk} not "
                         f"supported (P a multiple of {P_ALIGN}, shared "
                         f"memory {smem_bytes(p, n, chunk)} <= {MAX_SMEM})")
    named = dict(x=x, dt=dt, a=a, b_mat=b_mat, c_mat=c_mat)
    if d_skip is not None:
        named["d_skip"] = d_skip
    if init_state is not None:
        named["init_state"] = init_state
    for name, tensor in named.items():
        if tensor.device != x.device or tensor.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} must be on x's CUDA device")
    x = _rows(x, "x")
    if x.stride(-2) != p:
        x = x.contiguous()
    dt, b_mat, c_mat = (_rows(dt, "dt"), _rows(b_mat, "b_mat"),
                        _rows(c_mat, "c_mat"))
    a = _rows(a, "a").contiguous()
    if d_skip is not None:
        d_skip = _rows(d_skip, "d_skip").contiguous()
    if init_state is not None:
        init_state = _rows(init_state, "init_state").contiguous()
    lib = build.load()
    n_work = workspace_floats(bsz, t, h, p, n, chunk)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, t, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    build.check(lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), None if d_skip is None else d_skip.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        work.data_ptr(), n_work, y.data_ptr(), final.data_ptr(), bsz, t, h,
        p, n, chunk, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
        b_mat.stride(0), b_mat.stride(1), c_mat.stride(0), c_mat.stride(1),
        stream), "ssd_scan launch")
    ssd_scan.launches += 1
    ssd_scan.init_launches += init_state is not None
    return y, final


ssd_scan.launches = 0
ssd_scan.init_launches = 0


# ---------------------------------------------------------------------------
# the kernel's arithmetic in plain PyTorch (tests only)
# ---------------------------------------------------------------------------

def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (10 mantissa bits), ties away from
    zero: what ``cvt.rna.tf32.f32`` gives, as an f32."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of an f32 operand: big = tf32(a), small =
    tf32(a - big), the subtraction in f32."""
    big = tf32_round(a)
    return big, tf32_round(a.to(torch.float32) - big)


def _mm(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b in f32, or as the kernel's three tf32 products (small*big +
    big*small + big*big, each summed in f32)."""
    if not split:
        return a @ b
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def ssd_scan_mirror(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor,
                    d_skip: Optional[torch.Tensor] = None, *, chunk: int,
                    init_state: Optional[torch.Tensor] = None,
                    split: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's four steps in plain f32 PyTorch, with its roundings:
    cs summed in order in f32; scores C B^T in f32; the
    chunk states U = ((x dt) exp(cs_end - cs))^T B; the state passing
    S <- exp(cs_end) S + U, multiply and add rounded apart; y = (C exp(cs))
    S^T + (scores * L) (x dt) + D x. With ``split`` the three large
    products run as 3xTF32 (``tf32_split``). Shapes as ``ssd_scan``."""
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    pad = (-t) % chunk
    x, dt, b_mat, c_mat = (v.to(torch.float32) for v in (x, dt, b_mat, c_mat))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc, cl = (t + pad) // chunk, chunk
    xf = x.reshape(bsz, nc, cl, h, p).permute(0, 1, 3, 2, 4)  # [B,nc,H,cl,P]
    dtf = dt.reshape(bsz, nc, cl, h).permute(0, 1, 3, 2)     # [B,nc,H,cl]
    bf = b_mat.reshape(bsz, nc, 1, cl, n)
    cf = c_mat.reshape(bsz, nc, 1, cl, n)
    da = dtf * a.to(torch.float32)[None, None, :, None]
    cs = torch.empty_like(da)                                # [B,nc,H,cl]
    run = da[..., 0]
    cs[..., 0] = run
    for i in range(1, cl):                # in order in f32, as the kernel
        run = run + da[..., i]
        cs[..., i] = run
    cs_end = cs[..., -1:]
    xdt = xf * dtf[..., None]

    # 1. scores, f32, shared by the heads
    scores = cf @ bf.transpose(-1, -2)                       # [B,nc,1,i,j]
    # 2. chunk states: U = W^T B with W = (x dt) exp(cs_end - cs)
    w = xdt * torch.exp(cs_end - cs)[..., None]              # [B,nc,H,cl,P]
    u = _mm(w.transpose(-1, -2), bf, split)                  # [B,nc,H,P,N]
    # 3. state passing, in chunk order
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.to(torch.float32))
    decay = torch.exp(cs_end[..., 0])                        # [B,nc,H]
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, c, :, None, None] * s + u[:, c]
    s_in = torch.stack(s_in, dim=1)                          # [B,nc,H,P,N]
    # 4. chunk scan: the carry-in, then the intra-chunk product; L only
    # where j <= i (it overflows above)
    y = _mm(cf * torch.exp(cs)[..., None], s_in.transpose(-1, -2), split)
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=x.device))
    ell = torch.where(tri, torch.exp(cs[..., :, None] - cs[..., None, :]),
                      torch.zeros((), device=x.device))
    y = y + _mm(scores * ell, xdt, split)                    # [B,nc,H,cl,P]
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, nc * cl, h, p)[:, :t]
    if d_skip is not None:
        y = y + d_skip.to(torch.float32)[None, None, :, None] * x[:, :t]
    return y, s
