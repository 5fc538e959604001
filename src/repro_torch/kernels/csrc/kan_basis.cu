// Dense quantised KAN basis, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes the crossbar backends'
// word-line values in jnp (repro.core.quant.quantized_basis), and the port
// did the same in plain PyTorch. This kernel was added because that plain
// path was the largest stage of the crossbar cells on the H100: on
// CF-KAN-1 (cim_tiled, G 7) and CF-KAN-2 (cim, G 15) at batch 256 the
// kan.basis stage took 5.4 and 6.9 ms of a 9.2 and 11.6 ms batch, in ~15
// launches: the int32 code, its index, a gather of [256, 16384, 4] taps
// (2.5 ms alone), their flipped copy, and a compare, a select and an add
// over the whole dense tensor for each of the K+1 taps.
//
// For x [M] f32 (M = B * I, already bounded) and the SH-LUT hemi
// [ceil(L/2), K+1] f32 it writes out [M, S] f32, S = G + K, equal bit for
// bit to quant.quantized_basis(x, hemi, asp):
//   q     = clip(floor((x - x_min) / step), 0, G*L - 1)  (an f32 subtract
//           and a true f32 divide, as the reference; no fast math)
//   seg   = q >> LD,  local = q & (L - 1)
//   tap t = hemi[local, t], or hemi[L-1-local, K-t] when local >= ceil(L/2)
//   out[m, j] = 0 + tap (j - seg) when 0 <= j - seg <= K, else +0
// The plain path adds the one tap that lands in a slot to zeros, so each
// entry is a table value (a -0 tap read as +0, hence the add) or +0.
//
// What bounds it: bytes written. The output is G + K floats an input
// against one float read: 168 MB at CF-KAN-1's encoder (G 7) and 302 MB at
// CF-KAN-2's (G 15), 0.055 and 0.095 ms at 3.35 TB/s; the arithmetic (one
// divide an input, a compare and a select an entry) is far below that.
//
// Design: a block owns kInputs consecutive inputs, so its part of the
// output is one contiguous span of kInputs * S floats that starts on a
// 16-byte boundary (kInputs is a multiple of 4). The table is copied into
// shared memory, each thread computes the code of kInputs / kThreads
// inputs (coalesced reads of x) into a shared (seg, first tap) pair, and
// after one barrier the block writes its span with 16-byte stores,
// neighbouring threads on neighbouring addresses, every entry computed
// from the shared pair of its input: each output byte is written once,
// with no zero fill first, and nothing but x, the table and the output
// touches device memory. A span whose length is not a multiple of 4 (the
// grid's last block) ends in scalar stores. Any G, K, LD and M.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInputs = 1024;     // inputs a block writes the basis of
constexpr int kMaxS = 1 << 20;    // so that kInputs * S fits in an int
constexpr size_t kMaxSmem = 232448;

static_assert(kInputs % 4 == 0, "a block's span must start 16-byte aligned");

// One input's code: (seg, 2 * the table offset of its tap 0 + reflected).
__device__ __forceinline__ int2 code_of(float xv, int ld, int n_levels,
                                        int half, int k1, float x_min,
                                        float step) {
  // an f32 subtract and a true f32 divide, as the reference
  float qf = floorf(__fdiv_rn(__fsub_rn(xv, x_min), step));
  qf = fminf(fmaxf(qf, 0.f), (float)(n_levels - 1));
  const int q = (int)qf;
  const int L = 1 << ld;
  const int local = q & (L - 1);
  const int first = local < half ? 2 * (local * k1)
                                 : 2 * ((L - 1 - local) * k1 + k1 - 1) + 1;
  return make_int2(q >> ld, first);
}

// Entry j of the input whose code is c.
__device__ __forceinline__ float entry(const float* table, int2 c, int j,
                                       int k1) {
  const int t = j - c.x;
  if ((unsigned)t >= (unsigned)k1) return 0.f;
  const int at = (c.y >> 1) + ((c.y & 1) ? -t : t);
  return __fadd_rn(table[at], 0.f);   // -0 -> +0, as 0 + tap plainly
}

__global__ void __launch_bounds__(kThreads) kan_basis_dense(
    const float* __restrict__ x, const float* __restrict__ hemi,
    float* __restrict__ out, long long n_inputs, int S, int k1, int ld,
    int n_levels, int half, float x_min, float step) {
  extern __shared__ float table[];            // hemi [half, k1]
  __shared__ int2 codes[kInputs];
  for (int t = threadIdx.x; t < half * k1; t += kThreads) table[t] = hemi[t];
  const long long m0 = (long long)blockIdx.x * kInputs;
  const int n_here = (int)(n_inputs - m0 < kInputs ? n_inputs - m0
                                                   : kInputs);
  for (int q = threadIdx.x; q < n_here; q += kThreads)
    codes[q] = code_of(x[m0 + q], ld, n_levels, half, k1, x_min, step);
  __syncthreads();

  float* o = out + m0 * S;                    // 16-byte aligned
  const int span = n_here * S;
  const int n4 = span >> 2;
  // float4 f4 starts at entry j of input m; a thread steps by kThreads
  // float4s, i.e. dq inputs and dr entries
  const int dq = (4 * kThreads) / S, dr = (4 * kThreads) % S;
  int f4 = threadIdx.x;
  int m = (4 * f4) / S, j = 4 * f4 - m * S;
  for (; f4 < n4; f4 += kThreads) {
    int mm = m, jj = j;
    int2 c = codes[mm];
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = entry(table, c, jj, k1);
      if (++jj == S && e < 3) {
        jj = 0;
        c = codes[++mm];
      }
    }
    reinterpret_cast<float4*>(o)[f4] = make_float4(v[0], v[1], v[2], v[3]);
    m += dq;
    j += dr;
    if (j >= S) {
      j -= S;
      ++m;
    }
  }
  // the ragged tail, by the one thread whose next float4 would hold it
  if (f4 == n4 && (span & 3)) {
    int2 c = codes[m];
    for (int e = 4 * n4; e < span; ++e) {
      o[e] = entry(table, c, j, k1);
      if (++j == S && e + 1 < span) {
        j = 0;
        c = codes[++m];
      }
    }
  }
}

}  // namespace

// x [n_inputs] f32, hemi [half, k1] f32, out [n_inputs, S] f32, all
// contiguous on the current device, out 16-byte aligned. S = G + k1 - 1,
// n_levels = G << ld, half = ceil(2^ld / 2). Returns the first CUDA error,
// else cudaGetLastError().
extern "C" int kan_basis_launch(const float* x, const float* hemi, float* out,
                                long long n_inputs, int S, int k1, int ld,
                                int n_levels, int half, float x_min,
                                float step, void* stream) {
  if (k1 < 1 || ld < 0 || ld > 24 || S < k1 || S >= kMaxS || n_inputs < 0)
    return (int)cudaErrorInvalidValue;
  const int L = 1 << ld;
  if (half != (L + 1) / 2 ||
      (long long)n_levels != (long long)(S - k1 + 1) * L ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_inputs == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)half * k1 * sizeof(float);
  if (smem + kInputs * sizeof(int2) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 - kInputs * sizeof(int2)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kan_basis_dense, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (n_inputs + kInputs - 1) / kInputs;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kan_basis_dense<<<(unsigned)blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, hemi, out, n_inputs, S, k1, ld, n_levels, half, x_min, step);
  return (int)cudaGetLastError();
}
