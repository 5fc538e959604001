// Chunked Mamba-2 SSD scan (state-space duality), hand-written for Hopper
// (sm_90a), chunk-parallel, its large products on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:77 ssd_scan
// (_ssd_kernel). Per (batch b, head h), over chunks of cl steps, with
// da = dt * a (<= 0) and cs its inclusive cumsum inside the chunk:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (intra)
//         + exp(cs_i) (C_i . S_c[p, :])                         (carry-in)
//         + D x_i                                               (skip)
//   S_{c+1} = exp(cs_end) S_c + U_c,
//   U_c     = sum_j exp(cs_end - cs_j) dt_j x_j (x) B_j          (chunk state)
// with the [P, N] state S carried across chunks. It also reads an optional
// initial state and writes the final one, which the TPU kernel does not:
// the serving prefill needs both. Rows past T act as the dt = 0 rows the
// JAX wrapper pads with (exact no-ops).
//
// What bounds it on this card: operations. At mamba2-1.3b's width (H 64,
// P 64, N 128, cl 256, B 4, T 2048) the chunked algorithm is ~26.5 GFLOP
// per layer against ~0.28 GB moved. The TPU kernel's grid runs the chunks
// in order with the state in VMEM; on 132 SMs that order serialises the
// large products. So the scan runs as five kernels on the current stream,
// and only the elementwise [P, N] recurrence is serial over chunks:
//  0. split B: B's rows, shared by every head, split once (below) into the
//     workspace.
//  1. scores: C B^T once per (b, chunk), lower triangle at 32-row tiles,
//     scalar f32 (0.27 GFLOP per layer; it does not depend on the head),
//     row-major [i][j] into the workspace.
//  2. chunk state, one block per (b, h, chunk): cs summed in order in f32
//     by one thread (256 dependent adds, ~0.6 us, while the first tiles'
//     copies land), as torch.cumsum sums along a dim that is not the
//     innermost on the card, so that every cs_i - cs_j carries the plain
//     form's rounding. A scan in another order moves each cs by about an
//     ulp of |cs| (1.5e-5 at |cs| ~ 200): with a correctly rounded f64 scan
//     the full-width cuda test against the plain form
//     (tests/test_torch_ssd.py::test_ssd_kernel_full_width_chunk) failed.
//     Then U_c = (xdt * exp(cs_end - cs))^T [P, cl] @ B_c [cl, N] on the
//     tensor cores; U_c, cs and exp(cs_end) go to the workspace.
//  3. state passing, elementwise over [P, N]: S_c = exp(cs_end,c-1) S_c-1 +
//     U_c-1 from init_state in chunk order, rounded as the plain form rounds
//     it (no FMA), written over U in place; the final state to `fin`.
//  4. chunk scan, one block per (b, h, chunk, 64-row tile of i): y over the
//     concatenated contraction [C_i exp(cs_i) | (scores * L)_i] @
//     [S_c^T ; xdt], where L[i, j] = exp(cs_i - cs_j) is formed only for
//     j <= i, once per (b, h, i, j); for i < j it would overflow. Tiles of j
//     past the row tile are skipped, and the carry-in when S_c is zero.
//
// Precision: 3xTF32. Each f32 operand a is split into big =
// cvt.rna.tf32(a) and small = cvt.rna.tf32(a - big), and mma.sync.m16n8k8
// (tf32, f32 accumulate) runs small*big + big*small + big*big: ~2^-21
// |a||b| per product, below the JAX suite's atol 3e-5, rtol 1e-4. Built
// without fast math: expf, not __expf.
//
// Where the time goes, and the design against it: with both operands split
// in shared memory, the split tiles' bytes (8 per element, read by every
// warp of the block) and the split passes between barriers held a first
// design far below what mma.sync reaches. So each warp owns whole rows of
// A (16 rows, all 64 or 128 columns of its tile) and builds its A fragments
// in registers from raw f32 tiles: the decayed scores (each exp computed by
// exactly one thread), C exp(cs_i), or (x dt) w. Only B is split in shared
// memory: xdt and the state by the block, B's rows once per call by kernel
// 0. Raw A tiles arrive by cp.async (16 bytes a thread where the inputs are
// 16-byte aligned, else 4; zero-filled past every edge) three k-blocks
// deep, so one barrier a k-block suffices; row strides keep every fragment
// load free of bank conflicts. Per k-step a warp issues small*big for every
// n8 tile, then big*small, then big*big, so that no MMA waits on the one
// before it. What is left is latency between the loads, the A fragments'
// arithmetic and the MMAs of one k-step: wgmma, which takes B from shared
// memory asynchronously, is the next step. ssd_mma_probe measures the rate
// of the MMA building block alone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;
constexpr int kTile = 32;      // scores tile (32 x 32 outputs per block)
// chunk-state kernel: 8 warps (4 over p, 2 over n), a 64 (p) x 128 (n)
// tile, 16-row k-blocks; raw x [k][72] and split B [k][132] in 3 slots
constexpr int kStThreads = 256, kStM = 64, kStN = 128, kStK = 16;
constexpr int kStXS = kStM + 8, kStBS = kStN + 4;
// chunk-scan kernel: 4 warps (16 rows each), a 64 (i) x 64 (p) tile, 32-
// deep k-blocks; raw A [64][36] in 3 slots, split B in 2 ([j][68] of xdt,
// or [p][36] of the state)
constexpr int kScThreads = 128, kScM = 64, kScN = 64, kScK = 32;
constexpr int kScAS = kScK + 4, kScBk = kScN + 4, kScBp = kScK + 4;
constexpr int kScBs = kScK * kScBk > kScM * kScBp ? kScK * kScBk
                                                  : kScM * kScBp;

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

size_t state_smem(int cl) {
  return sizeof(float) * (3 * kStK * kStXS + 2 * (size_t)cl) +
         sizeof(uint2) * 3 * kStK * kStBS;
}

size_t scan_smem(int cl) {
  return sizeof(float) * (3 * kScM * kScAS + 2 * (size_t)cl) +
         sizeof(uint2) * 2 * kScBs;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// V bytes from src to dst, or V zero bytes when !ok (src is then not read)
template <int V>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  const unsigned n = ok ? V : 0;
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols floats at src (row stride ld) into dst [rows][dld]: element
// (r, c) is copied when r < r_ok and c < c_ok, else zero-filled. With V = 16
// c_ok, ld, dld and src must keep every 4-float vector 16-byte aligned.
template <int V, int NT>
__device__ __forceinline__ void load_tile(float* dst, int dld,
                                          const float* src, long long ld,
                                          int rows, int cols, int r_ok,
                                          int c_ok, int tid) {
  constexpr int E = V / 4;
  const int per_row = cols / E;
  for (int q = tid; q < rows * per_row; q += NT) {
    const int r = q / per_row, c = (q % per_row) * E;
    const bool ok = r < r_ok && c < c_ok;
    copy_async<V>(dst + r * dld + c, ok ? src + r * ld + c : src, ok);
  }
}

// {big, small}: a = big + small to ~2^-21 relative, each a tf32 value
__device__ __forceinline__ uint2 split_tf32(float a) {
  unsigned big, small;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(a));
  const float r = __fsub_rn(a, __uint_as_float(big));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(r));
  return make_uint2(big, small);
}

// the splits of four neighbouring values into four float2 slots (32 bytes)
__device__ __forceinline__ void store_split4(uint2* dst, float4 v) {
  const uint2 s0 = split_tf32(v.x), s1 = split_tf32(v.y);
  const uint2 s2 = split_tf32(v.z), s3 = split_tf32(v.w);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(s0.x, s0.y, s1.x, s1.y);
  d[1] = make_uint4(s2.x, s2.y, s3.x, s3.y);
}

__device__ __forceinline__ void mma_tf32(float* d, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k-step (8 deep) of a warp's 16-row band against NT n8 tiles, in
// 3xTF32, from the split A fragment a (rows g, g+8 x columns t, t+4) and
// split B at B[k * bk + n * bn] (k from this k-step's first): small*big for
// every tile, then big*small, then big*big, so that no MMA waits on the one
// before it. Tile j is skipped when !(live >> j & 1).
template <int NT>
__device__ __forceinline__ void mma_kstep(float (*acc)[4], const uint2* a,
                                         const uint2* B, int bk, int bn,
                                         unsigned live, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint2 b[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (live >> j & 1) {
      b[j][0] = B[t * bk + (j * 8 + g) * bn];
      b[j][1] = B[(t + 4) * bk + (j * 8 + g) * bn];
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (live >> j & 1)
      mma_tf32(acc[j], a[0].y, a[1].y, a[2].y, a[3].y, b[j][0].x, b[j][1].x);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (live >> j & 1)
      mma_tf32(acc[j], a[0].x, a[1].x, a[2].x, a[3].x, b[j][0].y, b[j][1].y);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (live >> j & 1)
      mma_tf32(acc[j], a[0].x, a[1].x, a[2].x, a[3].x, b[j][0].x, b[j][1].x);
}

// ---------------------------------------------------------------------------
// 0. split B: out[b][t][n] = {big, small} of B[b, t, n] (row stride ldn;
// zeros in the padding columns).
__global__ void __launch_bounds__(256)
ssd_split_kernel(const float* __restrict__ bm, uint2* __restrict__ out, int T,
                 int N, int ldn, long long sbb, long long sbt) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)T * ldn) return;
  const int b = blockIdx.y;
  const long long t = e / ldn;
  const int n = (int)(e % ldn);
  out[(long long)b * T * ldn + e] =
      split_tf32(n < N ? bm[b * sbb + t * sbt + n] : 0.f);
}

// ---------------------------------------------------------------------------
// 1. scores: st[b][c][i][j] = sum_n C[b, c cl + i, n] B[b, c cl + j, n] for
// 32-tiles on or below the diagonal (row stride lds); rows past T read as
// zeros, tiles of rows past T are skipped.
__global__ void __launch_bounds__(256)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ st, int T, int N, int cl, int nc,
                  int lds, long long sbb, long long sbt, long long scb,
                  long long sct) {
  __shared__ float c_s[kTile][kTile + 1];  // [n][i]
  __shared__ float b_s[kTile][kTile + 1];  // [n][j]
  const int n_tiles = (cl + kTile - 1) / kTile;
  const int ti = blockIdx.x / n_tiles, tj = blockIdx.x % n_tiles;
  const int c = blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)c * cl;
  const int i0 = ti * kTile, j0 = tj * kTile;
  if (tj > ti || t0 + i0 >= T) return;  // above the diagonal or past T
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;  // 32 x 8
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int n = n0 + tx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = ty + 8 * k;
      const int ri = i0 + r, rj = j0 + r;
      float cv = 0.f, bv = 0.f;
      if (n < N && ri < cl && t0 + ri < T)
        cv = cm[b * scb + (t0 + ri) * sct + n];
      if (n < N && rj < cl && t0 + rj < T)
        bv = bm[b * sbb + (t0 + rj) * sbt + n];
      c_s[tx][r] = cv;
      b_s[tx][r] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int q = 0; q < kTile; ++q) {
      const float bv = b_s[q][tx];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(c_s[q][ty + 8 * k], bv, acc[k]);
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j >= cl) return;
  float* out = st + ((long long)b * nc + c) * cl * lds;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + ty + 8 * k;
    if (i < cl) out[(long long)i * lds + j] = acc[k];
  }
}

// ---------------------------------------------------------------------------
// 2. chunk state, one block per (chunk, p-block of 64, n-block of 128) x h x
// b: cs of the chunk, then U = W^T B_c with W[j][p] = (x[j][p] dt_j)
// exp(cs_end - cs_j). Warp w owns p rows 16 (w % 4) .. +16 and n columns
// 64 (w / 4) .. +64, and builds its A fragments from the raw x tile.
template <int V>
__global__ void __launch_bounds__(kStThreads, 2)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const uint2* __restrict__ bsp,
                 float* __restrict__ u, float* __restrict__ cs_out,
                 float* __restrict__ decay, int T, int H, int P, int N,
                 int cl, int nc, int ldn, long long sxb, long long sxt,
                 long long sdb, long long sdt) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* bs = reinterpret_cast<uint2*>(smem);  // [3][kStK][132]
  float* raw_x = reinterpret_cast<float*>(bs + 3 * kStK * kStBS);  // [3][k][72]
  float* dt_s = raw_x + 3 * kStK * kStXS;      // [cl]
  float* w_s = dt_s + cl;                      // [cl]: da, cs, w

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_pb = (P + kStM - 1) / kStM, n_nb = (N + kStN - 1) / kStN;
  const int c = blockIdx.x / (n_pb * n_nb);
  const int pb = blockIdx.x / n_nb % n_pb, nb = blockIdx.x % n_nb;
  const int h = blockIdx.y, b = blockIdx.z;
  const int p0 = pb * kStM, n0 = nb * kStN;
  const long long t0 = (long long)c * cl;
  const int rows = (int)min((long long)cl, T - t0);
  const int nk = (rows + kStK - 1) / kStK;
  const float* xb = x + b * sxb + t0 * sxt + (long long)h * P + p0;
  const uint2* bb = bsp + ((long long)b * T + t0) * ldn + n0;

  // raw x and split B rows of k-block kb into slot kb % 3
  auto stage = [&](int kb) {
    const int j0 = kb * kStK, s = kb % 3;
    load_tile<V, kStThreads>(raw_x + s * kStK * kStXS, kStXS, xb + j0 * sxt,
                             sxt, kStK, kStM, rows - j0, P - p0, tid);
    uint2* dst = bs + s * kStK * kStBS;
    for (int q = tid; q < kStK * kStN / 2; q += kStThreads) {
      const int r = q / (kStN / 2), cc = q % (kStN / 2) * 2;
      const bool ok = r < rows - j0 && n0 + cc < ldn;
      copy_async<16>(dst + r * kStBS + cc,
                     ok ? bb + (long long)(j0 + r) * ldn + cc : bb, ok);
    }
    copy_commit();
  };
  stage(0);
  if (nk > 1) stage(1); else copy_commit();

  // cs: dt a per row in f32 (rows past T: 0), summed in order in f32 by one
  // thread while the first tiles' copies land
  const float a_h = a[h];
  for (int j = tid; j < cl; j += kStThreads) {
    const float d = j < rows ? dt[b * sdb + (t0 + j) * sdt + h] : 0.f;
    dt_s[j] = d;
    w_s[j] = __fmul_rn(d, a_h);
  }
  __syncthreads();
  if (tid == 0) {
    float run = w_s[0];
#pragma unroll 8
    for (int j = 1; j < cl; ++j) w_s[j] = run = __fadd_rn(run, w_s[j]);
  }
  __syncthreads();
  const float cs_end = w_s[cl - 1];
  const long long bhc = ((long long)b * H + h) * nc + c;
  __syncthreads();
  for (int j = tid; j < cl; j += kStThreads) {
    const float cs = w_s[j];
    if (pb == 0 && nb == 0) cs_out[bhc * cl + j] = cs;
    w_s[j] = expf(cs_end - cs);
  }
  if (tid == 0 && pb == 0 && nb == 0) decay[bhc] = expf(cs_end);

  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 64;
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (n0 + wn + j * 8 < N) live |= 1u << j;
  if (p0 + wm >= P) live = 0;  // a band wholly past P
  float acc[8][4] = {};

  for (int kb = 0; kb < nk; ++kb) {
    copy_wait<1>();   // k-block kb landed (this thread's copies)
    __syncthreads();  // ... everyone's; w_s; MMA kb - 1 done
    if (kb + 2 < nk) stage(kb + 2); else copy_commit();
    if (!live) continue;
    const int s = kb % 3, j0 = kb * kStK;
    const float* rx = raw_x + s * kStK * kStXS + wm + g;
#pragma unroll
    for (int k0 = 0; k0 < kStK; k0 += 8) {
      // A[p][j] = (x[j][p] dt_j) w_j, rounded as the plain form rounds it;
      // fragment e is (row g + 8 (e & 1), column t + 4 (e >> 1)); rows past
      // the chunk's T are zero
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + t + (e >> 1) * 4, j = j0 + kk;
        v[e] = j < rows ? __fmul_rn(__fmul_rn(rx[kk * kStXS + (e & 1) * 8],
                                              dt_s[j]), w_s[j])
                        : 0.f;
      }
      const uint2 af[4] = {split_tf32(v[0]), split_tf32(v[1]),
                           split_tf32(v[2]), split_tf32(v[3])};
      mma_kstep<8>(acc, af, bs + s * kStK * kStBS + k0 * kStBS + wn, kStBS,
                   1, live, lane);
    }
  }

  // U[b, h, c, p, n] (row stride ldn); columns past N hold zeros
  float* ub = u + bhc * P * ldn;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + wn + j * 8 + 2 * t;
    if (n >= ldn) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = p0 + wm + g + hh * 8;
      if (p < P)
        *reinterpret_cast<float2*>(ub + (long long)p * ldn + n) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. state passing over chunks, elementwise over [P, ldn]: u[c] is replaced
// by the state entering chunk c; the final state goes to fin [B, H, P, N].
__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ u, const float* __restrict__ decay,
                const float* __restrict__ init, float* __restrict__ fin,
                int H, int P, int N, int nc, int ldn) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P * ldn) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int p = e / ldn, n = e % ldn;
  const long long bh = (long long)b * H + h;
  float s = (init != nullptr && n < N) ? init[(bh * P + p) * N + n] : 0.f;
  float* up = u + bh * nc * P * ldn + e;
  const long long step = (long long)P * ldn;
  float nxt = up[0];
  for (int c = 0; c < nc; ++c) {
    const float uc = nxt;
    if (c + 1 < nc) nxt = up[(c + 1) * step];
    up[c * step] = s;
    s = __fadd_rn(__fmul_rn(decay[bh * nc + c], s), uc);
  }
  if (n < N) fin[(bh * P + p) * N + n] = s;
}

// ---------------------------------------------------------------------------
// 4. chunk scan, one block per (chunk, 64-row tile i) x (h, p-block of 64) x
// b. The contraction runs over k-blocks: first the carry-in, A = C_i
// exp(cs_i) [64 x N], B = S_c^T (skipped when S_c is zero), then the intra-
// chunk part, A = scores * L [64 x j], B = xdt [j x 64], for j below the
// tile's end. Warp w owns rows 16 w .. +16 and all 64 columns, and builds
// its A fragments from the raw tile; the block splits B from registers
// loaded one k-block ahead.
template <int V>
__global__ void __launch_bounds__(kScThreads, 3)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ cm,
                const float* __restrict__ dskip,
                const float* __restrict__ st, const float* __restrict__ s_in,
                const float* __restrict__ cs_in, float* __restrict__ y,
                int T, int H, int P, int N, int cl, int nc, int lds, int ldn,
                int carry_first, long long sxb, long long sxt, long long sdb,
                long long sdt, long long scb, long long sct) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* bs = reinterpret_cast<uint2*>(smem);               // [2][kScBs]
  float* raw_a = reinterpret_cast<float*>(bs + 2 * kScBs);  // [3][64][36]
  float* cs_s = raw_a + 3 * kScM * kScAS;                   // [cl]
  float* dt_s = cs_s + cl;                                  // [cl]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_it = (cl + kScM - 1) / kScM, n_pb = (P + kScN - 1) / kScN;
  const int c = blockIdx.x / n_it;
  const int it = n_it - 1 - blockIdx.x % n_it;  // the longest tiles first
  const int h = blockIdx.y / n_pb, pb = blockIdx.y % n_pb, b = blockIdx.z;
  const int i0 = it * kScM, p0 = pb * kScN;
  const long long t0 = (long long)c * cl;
  const int rows = (int)min((long long)cl, T - t0);
  if (i0 >= rows) return;  // the whole tile past T
  const int jend = min(i0 + kScM, rows);  // j <= i < i0 + 64, j < rows
  const long long bhc = ((long long)b * H + h) * nc + c;
  // the carry-in when the state entering the chunk can be nonzero
  const int nkc = (c > 0 || carry_first) ? (N + kScK - 1) / kScK : 0;
  const int nk = nkc + (jend + kScK - 1) / kScK;
  const float* cb = cm + b * scb + (t0 + i0) * sct;
  const float* sb = s_in + bhc * P * ldn + (long long)p0 * ldn;
  const float* stb = st + ((long long)b * nc + c) * cl * lds +
                     (long long)i0 * lds;
  const float* xb = x + b * sxb + t0 * sxt + (long long)h * P + p0;

  // the raw A tile of k-block kb into slot kb % 3
  auto stage = [&](int kb) {
    float* ra = raw_a + (kb % 3) * kScM * kScAS;
    if (kb < nkc) {
      const int n0 = kb * kScK;
      load_tile<V, kScThreads>(ra, kScAS, cb + n0, sct, kScM, kScK,
                               rows - i0, N - n0, tid);
    } else {
      const int j0 = (kb - nkc) * kScK;
      load_tile<16, kScThreads>(ra, kScAS, stb + j0, lds, kScM, kScK,
                                rows - i0, lds - j0, tid);
    }
    copy_commit();
  };
  // this thread's 4-float pieces of k-block kb's raw B tile: the state
  // [64 p][32 n], or x [32 j][64 p]; zero past every edge
  constexpr int kPieces = kScM * kScK / 4 / kScThreads;
  float4 breg[kPieces];
  auto load_b = [&](int kb) {
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const int e = tid + q * kScThreads;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kb < nkc) {
        const int r = e / (kScK / 4), cc = e % (kScK / 4) * 4;
        const int n = kb * kScK + cc;
        if (r < P - p0 && n < ldn)
          v = *reinterpret_cast<const float4*>(sb + (long long)r * ldn + n);
      } else {
        const int r = e / (kScN / 4), cc = e % (kScN / 4) * 4;
        const int j = (kb - nkc) * kScK + r;
        if (j < rows && cc < P - p0) {
          const float* src = xb + (long long)j * sxt + cc;
          if constexpr (V == 16)
            v = *reinterpret_cast<const float4*>(src);
          else
            v = make_float4(src[0], src[1], src[2], src[3]);
        }
      }
      breg[q] = v;
    }
  };
  // split B of k-block kb from breg into slot kb & 1
  auto split_b = [&](int kb) {
    uint2* sbs = bs + (kb & 1) * kScBs;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const int e = tid + q * kScThreads;
      if (kb < nkc) {  // [p][n], as the state is stored
        const int r = e / (kScK / 4), cc = e % (kScK / 4) * 4;
        store_split4(sbs + r * kScBp + cc, breg[q]);
      } else {         // [j][p]: x dt
        const int r = e / (kScN / 4), cc = e % (kScN / 4) * 4;
        const int j = (kb - nkc) * kScK + r;
        const float d = j < jend ? dt_s[j] : 0.f;
        const float4 v = breg[q];
        store_split4(sbs + r * kScBk + cc,
                     make_float4(__fmul_rn(v.x, d), __fmul_rn(v.y, d),
                                 __fmul_rn(v.z, d), __fmul_rn(v.w, d)));
      }
    }
  };

  stage(0);
  if (nk > 1) stage(1); else copy_commit();
  load_b(0);
  for (int j = tid; j < jend; j += kScThreads) {
    cs_s[j] = cs_in[bhc * cl + j];
    dt_s[j] = dt[b * sdb + (t0 + j) * sdt + h];
  }
  __syncthreads();
  split_b(0);
  if (nk > 1) load_b(1);

  // this thread's two rows: i_a = i0 + 16 warp + g and i_b = i_a + 8
  const int ra_row = warp * 16 + g;
  const int i_a = i0 + ra_row, i_b = i_a + 8;
  const float cs_a = i_a < jend ? cs_s[i_a] : 0.f;
  const float cs_b = i_b < jend ? cs_s[i_b] : 0.f;
  const float e_a = i_a < jend ? expf(cs_a) : 0.f;
  const float e_b = i_b < jend ? expf(cs_b) : 0.f;
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (p0 + j * 8 < P) live |= 1u << j;
  float acc[8][4] = {};

  for (int kb = 0; kb < nk; ++kb) {
    copy_wait<1>();   // the raw A of k-block kb landed (this thread's)
    __syncthreads();  // ... everyone's; split B kb visible; MMA kb-1 done
    if (kb + 2 < nk) stage(kb + 2); else copy_commit();
    const float* ra = raw_a + (kb % 3) * kScM * kScAS + ra_row * kScAS;
    const uint2* sbs = bs + (kb & 1) * kScBs;
    if (kb < nkc) {
#pragma unroll
      for (int k0 = 0; k0 < kScK; k0 += 8) {
        // A = C_i exp(cs_i); C is zero past N and past T
        const uint2 af[4] = {
            split_tf32(__fmul_rn(ra[k0 + t], e_a)),
            split_tf32(__fmul_rn(ra[8 * kScAS + k0 + t], e_b)),
            split_tf32(__fmul_rn(ra[k0 + t + 4], e_a)),
            split_tf32(__fmul_rn(ra[8 * kScAS + k0 + t + 4], e_b))};
        mma_kstep<8>(acc, af, sbs + k0, 1, kScBp, live, lane);
      }
    } else {
      const int j0 = (kb - nkc) * kScK;
#pragma unroll
      for (int k0 = 0; k0 < kScK; k0 += 8) {
        // A = scores * L, L[i, j] = exp(cs_i - cs_j) formed only for
        // j <= i (for i < j it overflows), by this thread alone
        const int j = j0 + k0 + t;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (j <= i_a && i_a < jend)
          v[0] = __fmul_rn(ra[k0 + t], expf(cs_a - cs_s[j]));
        if (j <= i_b && i_b < jend)
          v[1] = __fmul_rn(ra[8 * kScAS + k0 + t], expf(cs_b - cs_s[j]));
        if (j + 4 <= i_a && i_a < jend)
          v[2] = __fmul_rn(ra[k0 + t + 4], expf(cs_a - cs_s[j + 4]));
        if (j + 4 <= i_b && i_b < jend)
          v[3] = __fmul_rn(ra[8 * kScAS + k0 + t + 4],
                           expf(cs_b - cs_s[j + 4]));
        const uint2 af[4] = {split_tf32(v[0]), split_tf32(v[1]),
                             split_tf32(v[2]), split_tf32(v[3])};
        mma_kstep<8>(acc, af, sbs + k0 * kScBk, kScBk, 1, live, lane);
      }
    }
    if (kb + 1 < nk) {
      split_b(kb + 1);  // into the slot MMA kb - 1 read
      if (kb + 2 < nk) load_b(kb + 2);
    }
  }

  // y = acc + D x, rows below T only
  const float d_h = dskip ? dskip[h] : 0.f;
  const long long y_t = (long long)H * P;  // y is contiguous [B, T, H, P]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = hh ? i_b : i_a;
    if (i >= rows) continue;
    const float* xr = xb + (long long)i * sxt;
    float* yr = y + ((long long)b * T + t0 + i) * y_t + (long long)h * P + p0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = j * 8 + 2 * t;
      if (p0 + q < P)
        *reinterpret_cast<float2*>(yr + q) =
            make_float2(acc[j][2 * hh] + d_h * xr[q],
                        acc[j][2 * hh + 1] + d_h * xr[q + 1]);
    }
  }
}

// The rate of the building block alone: each of 4 warps a block runs
// `iters` k-steps of the 3xTF32 MMAs of mma_kstep<8> (24 mma.sync, three
// passes over 8 accumulators) on register operands, with no shared memory
// and no other work, so that a caller can hold the kernels against what
// mma.sync reaches on the card. out gets one sum per thread (live results).
__global__ void __launch_bounds__(128)
ssd_mma_probe_kernel(float* __restrict__ out, int iters) {
  const int tid = threadIdx.x;
  const unsigned base = 0x3f800000u + (unsigned)(tid & 31) * 0x2000u;
  uint2 a[4], b[8][2];
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = make_uint2(base + e * 0x4000u, 0x34000000u);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    b[j][0] = b[j][1] = make_uint2(base + j * 0x6000u, 0x33800000u);
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_tf32(acc[j], a[0].y, a[1].y, a[2].y, a[3].y, b[j][0].x, b[j][1].x);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_tf32(acc[j], a[0].x, a[1].x, a[2].x, a[3].x, b[j][0].y, b[j][1].y);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_tf32(acc[j], a[0].x, a[1].x, a[2].x, a[3].x, b[j][0].x, b[j][1].x);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[(long long)blockIdx.x * blockDim.x + tid] = sum;
}

inline bool aligned16(const void* p, long long s0, long long s1) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 4 == 0 &&
         s1 % 4 == 0;
}

long long up4(long long v) { return (v + 3) / 4 * 4; }

// Workspace floats ssd_scan_launch needs: scores [B, nc, cl, round4(cl)],
// chunk states [B, H, nc, P, round4(N)], cs [B, H, nc, cl], decay [B, H,
// nc], each rounded up to 4 floats, and split B [B, T, round4(N)] float2s
// (kernels/ssd_scan.py::workspace_floats, which allocates it, mirrors this).
long long workspace_floats(int B, int T, int H, int P, int N, int cl) {
  const long long nc = (T + cl - 1) / cl;
  return up4((long long)B * nc * cl * round4(cl)) +
         up4((long long)B * H * nc * P * round4(N)) +
         up4((long long)B * H * nc * cl) + up4((long long)B * H * nc) +
         2LL * B * T * round4(N);
}

struct Work {  // the workspace's regions
  float *scores, *u, *cs, *decay;
  uint2* bsp;
};

template <int V>
int launch(const float* x, const float* dt, const float* a, const float* bm,
           const float* cm, const float* dskip, const float* init,
           const Work& w, float* y, float* fin, int B, int T, int H, int P,
           int N, int cl, int nc, int lds, int ldn, long long sxb,
           long long sxt, long long sdb, long long sdt, long long sbb,
           long long sbt, long long scb, long long sct, cudaStream_t s) {
  const size_t sm_state = state_smem(cl), sm_scan = scan_smem(cl);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm_state);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_kernel<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm_scan);
  if (err != cudaSuccess) return (int)err;
  ssd_split_kernel<<<dim3((unsigned)(((long long)T * ldn + 255) / 256), B),
                     256, 0, s>>>(bm, w.bsp, T, N, ldn, sbb, sbt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_tiles = (cl + kTile - 1) / kTile;
  ssd_scores_kernel<<<dim3(n_tiles * n_tiles, nc, B), 256, 0, s>>>(
      bm, cm, w.scores, T, N, cl, nc, lds, sbb, sbt, scb, sct);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_pb_st = (P + kStM - 1) / kStM, n_nb = (N + kStN - 1) / kStN;
  ssd_state_kernel<V><<<dim3(nc * n_pb_st * n_nb, H, B), kStThreads,
                        sm_state, s>>>(x, dt, a, w.bsp, w.u, w.cs, w.decay,
                                       T, H, P, N, cl, nc, ldn, sxb, sxt,
                                       sdb, sdt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_pass_kernel<<<dim3((P * ldn + 255) / 256, H, B), 256, 0, s>>>(
      w.u, w.decay, init, fin, H, P, N, nc, ldn);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n_it = (cl + kScM - 1) / kScM, n_pb = (P + kScN - 1) / kScN;
  ssd_scan_kernel<V><<<dim3(nc * n_it, H * n_pb, B), kScThreads, sm_scan,
                       s>>>(x, dt, cm, dskip, w.scores, w.u, w.cs, y, T, H,
                            P, N, cl, nc, lds, ldn, init != nullptr, sxb,
                            sxt, sdb, sdt, scb, sct);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T, H, P] f32 (last two dims contiguous, strides sxb, sxt), dt
// [B, T, H] f32 (last dim contiguous; sdb, sdt), a [H] f32, B/C [B, T, N]
// f32 (last dim contiguous; sbb, sbt / scb, sct), d_skip [H] f32 or null,
// init [B, H, P, N] f32 or null, work workspace_floats(...) f32 (n_work
// floats, 16-byte aligned), y [B, T, H, P] f32 contiguous, fin [B, H, P, N]
// f32 contiguous. P must be a multiple of 8. Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const float* x, const float* dt, const float* a,
                               const float* bm, const float* cm,
                               const float* dskip, const float* init,
                               float* work, long long n_work, float* y,
                               float* fin, int B, int T, int H, int P, int N,
                               int cl, long long sxb, long long sxt,
                               long long sdb, long long sdt, long long sbb,
                               long long sbt, long long scb, long long sct,
                               void* stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || cl < 1 || P < 8 || P % 8 ||
      B > 65535 || (long long)H * ((P + kScN - 1) / kScN) > 65535 ||
      state_smem(cl) > (size_t)kMaxSmem || scan_smem(cl) > (size_t)kMaxSmem ||
      n_work < workspace_floats(B, T, H, P, N, cl) ||
      reinterpret_cast<uintptr_t>(work) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (T + cl - 1) / cl;
  const int lds = round4(cl), ldn = round4(N);
  Work w;
  w.scores = work;
  w.u = w.scores + up4((long long)B * nc * cl * lds);
  w.cs = w.u + up4((long long)B * H * nc * P * ldn);
  w.decay = w.cs + up4((long long)B * H * nc * cl);
  w.bsp = reinterpret_cast<uint2*>(w.decay + up4((long long)B * H * nc));
  const bool vec = aligned16(x, sxb, sxt) && aligned16(bm, sbb, sbt) &&
                   aligned16(cm, scb, sct) && N % 4 == 0;
  if (vec)
    return launch<16>(x, dt, a, bm, cm, dskip, init, w, y, fin, B, T, H, P, N,
                      cl, nc, lds, ldn, sxb, sxt, sdb, sdt, sbb, sbt, scb,
                      sct, s);
  return launch<4>(x, dt, a, bm, cm, dskip, init, w, y, fin, B, T, H, P, N,
                   cl, nc, lds, ldn, sxb, sxt, sdb, sdt, sbb, sbt, scb, sct,
                   s);
}

// The MMA probe: `blocks` blocks of 128 threads, out [blocks * 128] f32;
// each block runs 4 * iters * 24 mma.sync.m16n8k8 (tf32). Returns
// cudaGetLastError().
extern "C" int ssd_mma_probe(float* out, int blocks, int iters, void* stream) {
  if (blocks < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  ssd_mma_probe_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return (int)cudaGetLastError();
}
