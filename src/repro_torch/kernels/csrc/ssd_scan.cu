// Chunked Mamba-2 SSD scan (state-space duality), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). Per (batch b, head h), over chunks of cl steps, with
// da = dt * a (<= 0) and cs its inclusive cumsum inside the chunk:
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j      (intra)
//         + exp(cs_i) (C_i . S[p, :])                           (carry-in)
//         + D x_i                                               (skip)
//   S    <- exp(cs_end) S + sum_j exp(cs_end - cs_j) dt_j x_j (x) B_j
// with the [P, N] state S carried across chunks. It also reads an optional
// initial state and writes the final one, which the TPU kernel does not:
// the serving prefill needs both. Rows past T act as the dt = 0 rows the
// JAX wrapper pads with (exact no-ops).
//
// What bounds it on this card: operations. At mamba2-1.3b's width (H 64,
// P 64, N 128, cl 256) the carry-in readout and the state update are each
// 2 T H P N flops, 17 GFLOP per layer at B=4 x T=2048, against ~0.28 GB
// moved (x in, y out, B, C, dt): far above the 20 flops per byte where f32
// work outside the tensor cores stops being bound by memory. No TF32: the
// products stay f32 FMAs (tensor cores through 3xTF32 splitting are later
// work).
//
// Design:
// - The TPU runs one program per (b, h) with the chunk loop inside. On 132
//   SMs (b, h) alone gives 256 blocks at B=4, so the grid also splits P
//   into slices of PB columns: row p of the state depends only on column p
//   of x, so (b, h, p-slice) blocks are independent (1024 at full width).
//   Each block keeps its [PB, N] slice of the state in shared memory across
//   the chunk loop, as the TPU kernel keeps [P, N] in VMEM.
// - C B^T does not depend on the head (n_groups = 1). A first kernel
//   computes it once per (b, chunk), lower triangle only, transposed
//   ([j][i], so that threads over i read it coalesced), into a scratch
//   buffer the wrapper allocates (B T cl floats, 9.4 MB at full width, held
//   in L2). The TPU kernel's [cl, cl] score tile would take 256 KB of the
//   227 KB of shared memory at cl = 256.
// - The mask: for i < j, cs_i - cs_j > 0 and exp() overflows to inf far
//   inside a 256-step chunk. The intra-chunk loop runs j <= i only, so
//   those entries are never formed (the JAX code selects them away).
// - A thread owns the rows i and cl-1-i of the chunk, so every thread
//   walks cl+1 (i, j) pairs: the triangle is balanced over the block. Per
//   pair one score load and one expf feed PB FMAs from shared memory.
// - The state update gives each thread columns n (coalesced B loads) and 8
//   state rows; the decay-weighted xdt rows are broadcasts from shared
//   memory.
// - cs is summed in order by one thread (cl adds), as torch.cumsum on the
//   CPU sums it. expf, not __expf, and no --use_fast_math: the bar is the
//   JAX suite's atol 3e-5, rtol 1e-4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // scores tile (32 x 32 outputs per block)
constexpr int kThreads = 128;  // chunk kernel block
constexpr int kMaxSmem = 232448;

// st[b][c][j][i] = sum_n C[b, c cl + i, n] B[b, c cl + j, n], for tiles on
// or below the diagonal; rows past T read as zeros.
__global__ void __launch_bounds__(256)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ st, int T, int N, int cl, int nc,
                  long long sbb, long long sbt, long long scb,
                  long long sct) {
  __shared__ float c_s[kTile][kTile + 1];  // [n][i]
  __shared__ float b_s[kTile][kTile + 1];  // [n][j]
  const int n_tiles = (cl + kTile - 1) / kTile;
  const int ti = blockIdx.x / n_tiles, tj = blockIdx.x % n_tiles;
  if (tj > ti) return;  // strictly above the diagonal: never read
  const int c = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;  // 32 x 8
  const int i0 = ti * kTile, j0 = tj * kTile;
  const long long t0 = (long long)c * cl;
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
      const float cv = c_s[q][tx];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(cv, b_s[q][ty + 8 * k], acc[k]);
    }
    __syncthreads();
  }
  const int i = i0 + tx;
  if (i >= cl) return;
  float* out = st + ((long long)b * nc + c) * cl * cl;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + ty + 8 * k;
    if (j < cl) out[(long long)j * cl + i] = acc[k];
  }
}

// One block per (p-slice of PB columns, head, batch); the chunk loop runs
// inside with the state slice in shared memory.
template <int PB>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ bm,
                 const float* __restrict__ cm,
                 const float* __restrict__ dskip,
                 const float* __restrict__ st,
                 const float* __restrict__ init, float* __restrict__ y,
                 float* __restrict__ fin, int T, int H, int P, int N, int cl,
                 int nc, long long sxb, long long sxt, long long sdb,
                 long long sdt, long long sbb, long long sbt, long long scb,
                 long long sct) {
  extern __shared__ float smem[];
  float* state = smem;                // [PB][N]
  float* xdt = state + PB * N;        // [cl][PB]
  float* cs = xdt + (long long)cl * PB;  // [cl]
  float* wout = cs + cl;              // [cl]: exp(cs_end - cs_j)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const float a_h = a[h];
  const float d_h = dskip ? dskip[h] : 0.f;
  const long long s_base = (((long long)b * H + h) * P + p0) * N;
  const float* xb = x + b * sxb + (long long)h * P + p0;
  const float* dtb = dt + b * sdb + h;
  const float* bb = bm + b * sbb;
  const float* cb = cm + b * scb;
  float* yb = y + ((long long)b * T * H + h) * P + p0;
  const long long y_t = (long long)H * P;  // y is contiguous [B, T, H, P]

  for (int e = tid; e < PB * N; e += kThreads)
    state[e] = init ? init[s_base + e] : 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * cl;
    const int rows = (int)min((long long)cl, T - t0);  // valid rows
    // dt x and dt a of the chunk; rows past T are dt = 0 no-ops
    for (int e = tid; e < cl * PB; e += kThreads) {
      const int i = e / PB, q = e % PB;
      float v = 0.f;
      if (i < rows) v = xb[(t0 + i) * sxt + q] * dtb[(t0 + i) * sdt];
      xdt[e] = v;
    }
    for (int i = tid; i < cl; i += kThreads)
      cs[i] = i < rows ? dtb[(t0 + i) * sdt] * a_h : 0.f;
    __syncthreads();
    if (tid == 0)
      for (int i = 1; i < cl; ++i) cs[i] += cs[i - 1];
    __syncthreads();
    const float cs_end = cs[cl - 1];
    for (int j = tid; j < cl; j += kThreads) wout[j] = expf(cs_end - cs[j]);

    // y for rows i and cl-1-i
    const float* stc = st + ((long long)b * nc + c) * cl * cl;
    for (int pair = tid; pair < (cl + 1) / 2; pair += kThreads) {
      for (int side = 0; side < 2; ++side) {
        const int i = side ? cl - 1 - pair : pair;
        if (side && i == pair) break;
        if (i >= rows) continue;
        const float cs_i = cs[i];
        float acc[PB];
#pragma unroll
        for (int q = 0; q < PB; ++q) acc[q] = 0.f;
        for (int j = 0; j <= i; ++j) {  // j > i never formed: exp overflows
          const float w = stc[(long long)j * cl + i] * expf(cs_i - cs[j]);
          const float* xr = xdt + j * PB;
#pragma unroll
          for (int q = 0; q < PB; ++q) acc[q] = fmaf(w, xr[q], acc[q]);
        }
        float off[PB];
#pragma unroll
        for (int q = 0; q < PB; ++q) off[q] = 0.f;
        const float* cr = cb + (t0 + i) * sct;
        for (int n = 0; n < N; ++n) {
          const float cv = cr[n];
#pragma unroll
          for (int q = 0; q < PB; ++q) off[q] = fmaf(cv, state[q * N + n], off[q]);
        }
        const float e_i = expf(cs_i);
        const float* xr = xb + (t0 + i) * sxt;
        float* yr = yb + (t0 + i) * y_t;
#pragma unroll
        for (int q = 0; q < PB; ++q)
          yr[q] = acc[q] + off[q] * e_i + d_h * xr[q];
      }
    }
    __syncthreads();  // every read of the old state is done

    // S <- exp(cs_end) S + sum_j (exp(cs_end - cs_j) xdt_j) (x) B_j
    const float decay = expf(cs_end);
    for (int e = tid; e < N * (PB / 8); e += kThreads) {
      const int n = e % N, g = e / N;
      float acc[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.f;
      for (int j = 0; j < rows; ++j) {
        const float bv = bb[(t0 + j) * sbt + n];
        const float wj = wout[j];
        const float* xr = xdt + j * PB + g * 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = fmaf(wj * xr[k], bv, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float* s = state + (g * 8 + k) * N + n;
        *s = decay * *s + acc[k];
      }
    }
    __syncthreads();  // the new state, and free xdt / cs for the next chunk
  }

  for (int e = tid; e < PB * N; e += kThreads) fin[s_base + e] = state[e];
}

template <int PB>
int launch_chunks(const float* x, const float* dt, const float* a,
                  const float* bm, const float* cm, const float* dskip,
                  const float* st, const float* init, float* y, float* fin,
                  int B, int T, int H, int P, int N, int cl, int nc,
                  long long sxb, long long sxt, long long sdb, long long sdt,
                  long long sbb, long long sbt, long long scb, long long sct,
                  cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)PB * N + (size_t)cl * PB + 2 * (size_t)cl);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(P / PB, H, B);
  ssd_chunk_kernel<PB><<<grid, kThreads, smem, stream>>>(
      x, dt, a, bm, cm, dskip, st, init, y, fin, T, H, P, N, cl, nc, sxb, sxt,
      sdb, sdt, sbb, sbt, scb, sct);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, T, H, P] f32 (last two dims contiguous, strides sxb, sxt), dt
// [B, T, H] f32 (last dim contiguous; sdb, sdt), a [H] f32, B/C [B, T, N]
// f32 (last dim contiguous; sbb, sbt / scb, sct), d_skip [H] f32 or null,
// init [B, H, P, N] f32 or null, scratch [B, nc, cl, cl] f32, y [B, T, H,
// P] f32 contiguous, fin [B, H, P, N] f32 contiguous; nc = ceil(T / cl).
// P must be a multiple of 8. Returns cudaGetLastError().
extern "C" int ssd_scan_launch(const float* x, const float* dt, const float* a,
                               const float* bm, const float* cm,
                               const float* dskip, const float* init,
                               float* scratch, float* y, float* fin, int B,
                               int T, int H, int P, int N, int cl,
                               long long sxb, long long sxt, long long sdb,
                               long long sdt, long long sbb, long long sbt,
                               long long scb, long long sct, void* stream) {
  if (B < 1 || T < 1 || H < 1 || N < 1 || cl < 1 || P < 8 || P % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (T + cl - 1) / cl;
  const int n_tiles = (cl + kTile - 1) / kTile;
  ssd_scores_kernel<<<dim3(n_tiles * n_tiles, nc, B), 256, 0, s>>>(
      bm, cm, scratch, T, N, cl, nc, sbb, sbt, scb, sct);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (P % 16 == 0)
    return launch_chunks<16>(x, dt, a, bm, cm, dskip, scratch, init, y, fin,
                             B, T, H, P, N, cl, nc, sxb, sxt, sdb, sdt, sbb,
                             sbt, scb, sct, s);
  return launch_chunks<8>(x, dt, a, bm, cm, dskip, scratch, init, y, fin, B,
                          T, H, P, N, cl, nc, sxb, sxt, sdb, sdt, sbb, sbt,
                          scb, sct, s);
}
