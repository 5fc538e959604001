// Fused KAN spline layer, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kan_fused.py::kan_fused
// (_kan_fused_kernel):
//   y[b, o] = scale[o] * sum_{i,s} E[b, i, s] * codes[i, s, o]
// where E is built on chip from x: q = floor((x - x_min) / step) clipped to
// [0, G*L - 1], seg = q >> LD, loc = q & (L - 1), and the K+1 SH-LUT taps
// (reversed when loc >= ceil(L/2)) land in basis slots seg .. seg+K.
//
// What bounds it on this card: the useful work is 2*B*I*(K+1)*O f32 flops
// (3.6 GFLOP per CF-KAN-1 layer at B=256: 54 us at the 67 TFLOP/s f32 rate)
// against about 34.6 MB moved (10 us at 3.35 TB/s), so it is bound by
// operations. The contraction must stay in f32 (no TF32), which keeps it on
// the CUDA cores in this first version.
//
// Design: a block owns a (BM x 32) output tile, one output column per lane,
// and loops over I inside the block: the TPU's sequential "arbitrary" grid
// axis and its VMEM accumulator become f32 registers. Each I chunk is split
// over the block's 8 warps, whose partial sums meet in shared memory at the
// end. For every (b, i) of a chunk the block computes q, seg and the K+1
// taps once into shared memory. The contraction then touches only those K+1
// nonzero taps, reading codes[i, seg+t, o] (int8 in HBM, widened in
// registers) where the TPU's MXU needed the dense E row. The SH-LUT (16x4
// floats at CF-KAN-1) sits in shared memory and is indexed directly. The
// scale is applied once in the epilogue. Ragged B, I and O edges are masked
// in the kernel, not padded. Short batch tiles (BM = 4) are used when the
// output is small, so the encoder's 256 x 108 output still fills the SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBO = 32;        // output columns per block, one per lane
constexpr int kCI = 64;        // inputs staged per chunk
constexpr int kMaxTaps = 4;    // K + 1 (cubic splines and below)
constexpr int kMaxHalf = 128;  // SH-LUT rows: L <= 256 when n_bits <= 8

// int8 -> f32 as an integer add and an f32 subtract instead of the
// quarter-rate I2F: 1.5 * 2^23 has an ulp of 1, so adding c to its bit
// pattern gives exactly 1.5 * 2^23 + c.
__device__ __forceinline__ float widen(int c) {
  return __int_as_float(0x4B400000 + c) - 12582912.0f;
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
kan_fused_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                 const float* __restrict__ scale,
                 const float* __restrict__ hemi, float* __restrict__ y, int B,
                 int I, int S, int O, int k1, int ld, int n_levels, int half,
                 float x_min, float step) {
  __shared__ float hemi_s[kMaxHalf * kMaxTaps];
  __shared__ int seg_s[BM][kCI];
  __shared__ float4 taps_s[BM][kCI];
  __shared__ float red_s[kWarps][BM][kBO];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int o = blockIdx.x * kBO + lane;
  const int b0 = blockIdx.y * BM;
  const int L = 1 << ld;

  for (int j = tid; j < half * k1; j += kThreads) hemi_s[j] = hemi[j];

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  for (int i0 = 0; i0 < I; i0 += kCI) {
    __syncthreads();  // hemi_s is written; the last chunk's readers are done
    for (int j = tid; j < BM * kCI; j += kThreads) {
      const int m = j / kCI, il = j % kCI;
      const int b = b0 + m, i = i0 + il;
      int seg = -1;  // marks a masked (b, i)
      float t[kMaxTaps] = {0.f, 0.f, 0.f, 0.f};
      if (b < B && i < I) {
        // an f32 subtract and a true f32 divide, as the reference computes q
        const float xv = x[(size_t)b * I + i];
        float qf = floorf(__fdiv_rn(__fsub_rn(xv, x_min), step));
        qf = fminf(fmaxf(qf, 0.f), (float)(n_levels - 1));
        const int q = (int)qf;
        seg = q >> ld;
        const int loc = q & (L - 1);
        const bool refl = loc >= half;
        const float* row = hemi_s + (refl ? L - 1 - loc : loc) * k1;
#pragma unroll
        for (int tt = 0; tt < kMaxTaps; ++tt)
          if (tt < k1) t[tt] = row[refl ? k1 - 1 - tt : tt];
      }
      seg_s[m][il] = seg;
      taps_s[m][il] = make_float4(t[0], t[1], t[2], t[3]);
    }
    __syncthreads();
    if (o < O) {
      const int n_i = min(kCI, I - i0);
      for (int il = warp; il < n_i; il += kWarps) {
        const int8_t* col = codes + (size_t)(i0 + il) * S * O + o;
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const int seg = seg_s[m][il];
          if (seg < 0) continue;
          const float4 tp = taps_s[m][il];
          const int8_t* c = col + (size_t)seg * O;
          float a = acc[m];
          a = fmaf(tp.x, widen(c[0]), a);
          if (k1 > 1) a = fmaf(tp.y, widen(c[O]), a);
          if (k1 > 2) a = fmaf(tp.z, widen(c[2 * O]), a);
          if (k1 > 3) a = fmaf(tp.w, widen(c[3 * O]), a);
          acc[m] = a;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < BM; ++m) red_s[warp][m][lane] = acc[m];
  __syncthreads();
  for (int j = tid; j < BM * kBO; j += kThreads) {
    const int m = j / kBO, ol = j % kBO;
    const int b = b0 + m, oo = blockIdx.x * kBO + ol;
    if (b < B && oo < O) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red_s[w][m][ol];
      y[(size_t)b * O + oo] = s * scale[oo];
    }
  }
}

template <int BM>
void launch(const float* x, const int8_t* codes, const float* scale,
            const float* hemi, float* y, int B, int I, int S, int O, int k1,
            int ld, int n_levels, int half, float x_min, float step,
            cudaStream_t stream) {
  const dim3 grid((O + kBO - 1) / kBO, (B + BM - 1) / BM);
  kan_fused_kernel<BM><<<grid, dim3(32, kWarps), 0, stream>>>(
      x, codes, scale, hemi, y, B, I, S, O, k1, ld, n_levels, half, x_min,
      step);
}

}  // namespace

// x [B, I] f32, codes [I, S, O] int8, scale [O] f32, hemi [half, k1] f32,
// y [B, O] f32, all contiguous on the device. Returns cudaGetLastError().
extern "C" int kan_fused_launch(const float* x, const int8_t* codes,
                                const float* scale, const float* hemi,
                                float* y, int B, int I, int S, int O, int k1,
                                int ld, int n_levels, int half, float x_min,
                                float step, void* stream) {
  if (k1 < 1 || k1 > kMaxTaps || half < 1 || half > kMaxHalf)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int o_tiles = (O + kBO - 1) / kBO;
  if ((long long)o_tiles * ((B + 15) / 16) >= 264)  // two blocks per SM
    launch<16>(x, codes, scale, hemi, y, B, I, S, O, k1, ld, n_levels, half,
               x_min, step, s);
  else
    launch<4>(x, codes, scale, hemi, y, B, I, S, O, k1, ld, n_levels, half,
              x_min, step, s);
  return (int)cudaGetLastError();
}
