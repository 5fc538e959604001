// Multi-tile RRAM-ACIM crossbar MAC with per-cell conductance gain and an
// integer digital reduction across row tiles, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cim_mac.py::cim_mac_tiled
// (_cim_mac_tiled_kernel). For each row tile of As rows, each output (b, c)
// and each bit k < 8:
//   term    = sign(w[r, c]) * fl(fl(v[b, r] * atten[r]) * gain[r, c])
//   psum_k  = sum over the tile's rows r whose bit k of |w[r, c]| is set
//   code_k  = (int) rint(psum_k / lsb)        (half to even, as jnp.round)
//   out[b, c] = sum_tiles sum_k code_k << k   (int32)
// with lsb = As * in_scale / (2^adc_bits - 1), computed by the caller.
//
// What bounds it on this card: as for cim_mac, each tile's eight bit-slice
// sums must be complete before the ADC reads them, so the MAC cannot become
// one product. The work is one f32 multiply per (b, r, c) (the gain) and
// one f32 add per set code bit: about 43 G predicated adds per CF-KAN-1
// layer at B=256 against 273 MB (encoder) or 123 MB (decoder) moved. It is
// bound by operations at the f32 rate.
//
// Design: the block shape of cim_mac.cu. A block owns a (4*RG x 32) output
// tile, one column per lane and four batch rows per thread; its 8 warps are
// RG groups of batch rows times 8/RG phases, and phase p takes every
// (8/RG)-th row tile. Inside a tile a thread keeps eight f32 partial sums
// per output and adds rows one at a time in row order with __fmul_rn /
// __fadd_rn, which nvcc does not contract into an FMA: with a gain the
// product is not exact, and an FMA would round otherwise than the plain
// version (kernels/ref.py), which adds the same terms in the same order.
// The product fl(va * gain) is formed once per (b, r, c) and added to every
// set bit's sum. A row's code, gain, attenuation and inputs are loaded with
// no branch between them, so their latencies overlap: skipping rows whose
// code is 0 would make the gain load wait on the code load. The ADC step is
// rintf(__fdiv_rn(psum, lsb)). Codes are added in uint32, so the reduction
// over tiles and phases is exact in any order (and a wrap, impossible at
// these sizes, is defined and equals int32's). Without a gain (ideal cells)
// a variant skips the multiply: va * 1.0 is exact, so the codes are the
// same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTM = 4;  // batch rows per thread

template <int RG, bool kGain>
__global__ void __launch_bounds__(kWarps * 32)
cim_mac_tiled_kernel(const float* __restrict__ v,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ gain,
                     const float* __restrict__ atten,
                     int32_t* __restrict__ out, int B, int R, int C, int As,
                     float lsb) {
  constexpr int kPhases = kWarps / RG;
  __shared__ uint32_t red_s[kWarps][kTM][32];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int rg = warp % RG, phase = warp / RG;
  const int c = blockIdx.x * 32 + lane;
  const int b0 = blockIdx.y * (RG * kTM) + rg * kTM;
  const int n_tiles = R / As;

  uint32_t acc[kTM];
#pragma unroll
  for (int m = 0; m < kTM; ++m) acc[m] = 0u;

  if (c < C) {
    for (int t = phase; t < n_tiles; t += kPhases) {
      float ps[kTM][8];
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int k = 0; k < 8; ++k) ps[m][k] = 0.f;
      const int r_end = (t + 1) * As;
      for (int r = t * As; r < r_end; ++r) {
        const size_t rc = (size_t)r * C + c;
        const int wv = w[rc];
        const int mag = wv < 0 ? -wv : wv;
        const float g = kGain ? gain[rc] : 1.f;
        const float at = atten[r];
#pragma unroll
        for (int m = 0; m < kTM; ++m) {
          const int b = b0 + m;
          const float va = b < B ? __fmul_rn(v[(size_t)b * R + r], at) : 0.f;
          float term = kGain ? __fmul_rn(va, g) : va;
          term = wv < 0 ? -term : term;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if ((mag >> k) & 1) ps[m][k] = __fadd_rn(ps[m][k], term);
        }
      }
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int code = (int)rintf(__fdiv_rn(ps[m][k], lsb));
          acc[m] += (uint32_t)code << k;
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
      uint32_t s = 0u;
#pragma unroll
      for (int p = 0; p < kPhases; ++p) s += red_s[p * RG + rg][m][lane];
      out[(size_t)b * C + c] = (int32_t)s;
    }
  }
}

template <int RG>
void launch(const float* v, const int8_t* w, const float* gain,
            const float* atten, int32_t* out, int B, int R, int C, int As,
            float lsb, cudaStream_t stream) {
  const dim3 grid((C + 31) / 32, (B + RG * kTM - 1) / (RG * kTM));
  if (gain != nullptr)
    cim_mac_tiled_kernel<RG, true><<<grid, dim3(32, kWarps), 0, stream>>>(
        v, w, gain, atten, out, B, R, C, As, lsb);
  else
    cim_mac_tiled_kernel<RG, false><<<grid, dim3(32, kWarps), 0, stream>>>(
        v, w, gain, atten, out, B, R, C, As, lsb);
}

}  // namespace

// v [B, R] f32, w [R, C] int8, gain [R, C] f32 or null (ideal cells),
// atten [R] f32, out [B, C] int32, all contiguous on the device; R a
// multiple of array_size. Returns cudaGetLastError().
extern "C" int cim_mac_tiled_launch(const float* v, const int8_t* w,
                                    const float* gain, const float* atten,
                                    int32_t* out, int B, int R, int C,
                                    int array_size, float lsb, void* stream) {
  if (array_size < 1 || R % array_size) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long c_tiles = (C + 31) / 32;
  if (c_tiles * ((B + 8 * kTM - 1) / (8 * kTM)) >= 264)  // two blocks per SM
    launch<8>(v, w, gain, atten, out, B, R, C, array_size, lsb, s);
  else
    launch<1>(v, w, gain, atten, out, B, R, C, array_size, lsb, s);
  return (int)cudaGetLastError();
}
