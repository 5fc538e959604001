// Bit-sliced RRAM-ACIM crossbar MAC, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cim_mac.py::cim_mac
// (_cim_mac_kernel). For each physical array of As rows and each bit k < 8:
//   psum_k  = sum_r v[b, r] * atten[r] * bit_k(|w[r, c]|) * sign(w[r, c])
//   readout = rint(psum_k / lsb) * lsb        (half to even, as jnp.round)
//   out[b, c] = sum_arrays sum_k 2^k * readout
// with lsb = As * in_scale / (2^adc_bits - 1), computed by the caller.
//
// What bounds it on this card: the ADC must follow each array's complete
// row sum, separately for every bit slice, so the MAC cannot become one
// product. The work is one f32 add per (b, r, c, k) whose bit is set and
// whose v*atten is nonzero: up to 8*B*R*C adds, 36 G per CF-KAN-1 layer at
// B=256, against 186 MB (encoder) or 36 MB (decoder) moved. It is bound by
// operations at the f32 rate.
//
// Design: a block owns a (4*RG x 32) output tile, one column per lane and
// four batch rows per thread, and loops over the arrays. Its 8 warps are RG
// groups of batch rows times 8/RG phases; phase p takes every (8/RG)-th
// array, and the phases' sums meet in shared memory at the end (RG = 1 for
// the encoder's small 256 x 108 output, so it still fills the SMs). Inside
// one array a thread keeps eight f32 partial sums per output, one per bit
// slice, and makes one pass over the As rows, reading v*atten and the code
// once per row. Rows are added one at a time in row order, as the plain
// version adds them, so the psums and hence the ADC readouts are
// bit-identical to it; only the final sum over arrays is ordered otherwise.
// The ragged final array stops at row R, which is the same as padding it
// with dead (atten 0) rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTM = 4;  // batch rows per thread

template <int RG>
__global__ void __launch_bounds__(kWarps * 32)
cim_mac_kernel(const float* __restrict__ v, const int8_t* __restrict__ w,
               const float* __restrict__ atten, float* __restrict__ out,
               int B, int R, int C, int As, float lsb) {
  constexpr int kPhases = kWarps / RG;
  __shared__ float red_s[kWarps][kTM][32];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int rg = warp % RG, phase = warp / RG;
  const int c = blockIdx.x * 32 + lane;
  const int b0 = blockIdx.y * (RG * kTM) + rg * kTM;
  const int n_arrays = (R + As - 1) / As;

  float acc[kTM];
#pragma unroll
  for (int m = 0; m < kTM; ++m) acc[m] = 0.f;

  if (c < C) {
    for (int a = phase; a < n_arrays; a += kPhases) {
      float ps[kTM][8];
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int k = 0; k < 8; ++k) ps[m][k] = 0.f;
      const int r_end = min(R, (a + 1) * As);
      for (int r = a * As; r < r_end; ++r) {
        const int wv = w[(size_t)r * C + c];
        const int mag = wv < 0 ? -wv : wv;
        const float at = atten[r];
#pragma unroll
        for (int m = 0; m < kTM; ++m) {
          const int b = b0 + m;
          float va = b < B ? __fmul_rn(v[(size_t)b * R + r], at) : 0.f;
          va = wv < 0 ? -va : va;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if ((mag >> k) & 1) ps[m][k] = __fadd_rn(ps[m][k], va);
        }
      }
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float q = __fmul_rn(rintf(__fdiv_rn(ps[m][k], lsb)), lsb);
          acc[m] = __fadd_rn(acc[m], __fmul_rn((float)(1 << k), q));
        }
    }
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) red_s[warp][m][lane] = acc[m];
  __syncthreads();
  if (phase == 0 && c < C) {
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const int b = b0 + m;
      if (b >= B) continue;
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kPhases; ++p) s += red_s[p * RG + rg][m][lane];
      out[(size_t)b * C + c] = s;
    }
  }
}

template <int RG>
void launch(const float* v, const int8_t* w, const float* atten, float* out,
            int B, int R, int C, int As, float lsb, cudaStream_t stream) {
  const dim3 grid((C + 31) / 32, (B + RG * kTM - 1) / (RG * kTM));
  cim_mac_kernel<RG><<<grid, dim3(32, kWarps), 0, stream>>>(
      v, w, atten, out, B, R, C, As, lsb);
}

}  // namespace

// v [B, R] f32, w [R, C] int8, atten [R] f32, out [B, C] f32, all
// contiguous on the device. Returns cudaGetLastError().
extern "C" int cim_mac_launch(const float* v, const int8_t* w,
                              const float* atten, float* out, int B, int R,
                              int C, int array_size, float lsb, void* stream) {
  if (array_size < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long c_tiles = (C + 31) / 32;
  if (c_tiles * ((B + 8 * kTM - 1) / (8 * kTM)) >= 264)  // two blocks per SM
    launch<8>(v, w, atten, out, B, R, C, array_size, lsb, s);
  else
    launch<1>(v, w, atten, out, B, R, C, array_size, lsb, s);
  return (int)cudaGetLastError();
}
