// Bit-sliced RRAM-ACIM crossbar MAC, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cim_mac.py::cim_mac
// (_cim_mac_kernel). For each physical array of As rows (the last one
// ragged where As does not divide R, as if padded with dead rows) and each
// bit k < 8:
//   psum_k  = sum_r fl(v[b, r] * atten[r]) * bit_k(|w[r, c]|) * sign(w[r, c])
//             in increasing row order
//   readout = fl(rint(psum_k / lsb) * lsb)    (half to even, as jnp.round)
//   out[b, c] = sum_arrays sum_k 2^k * readout   (f32)
// with lsb = As * in_scale / (2^adc_bits - 1), computed by the caller.
// Every readout equals kernels/ref.py's cim_mac_ref's bit for bit (finite
// inputs); only the f32 sum over arrays and slices runs in another order.
//
// The kernel is cim_mac_common.cuh's, with ideal cells (each term is
// +-fl(v * atten), the sign folded in exactly) and f32 readouts: what
// bounds it and its design are written there. Per array and batch row a
// thread adds 2^k * readout_k for k = 0..7 (the planes its warp met), then
// adds that to its part's sum, the arrays in order. Where the launch
// splits the arrays into parts across blocks, each part writes its sum to
// a slice of a scratch buffer and cim_mac_sum_parts adds the slices in
// part order, so two launches agree bit for bit (identity (d) there).
// This was chosen over summing the integers n_k << k exactly in 64 bits:
// a readout here is never converted to an integer, so no input reaches a
// range where a code would wrap or saturate, and nothing on the path has
// to check one. The scratch costs parts * B * C floats (the wrapper asks
// cim_mac_scratch for its size): ~28 MB and ~50 MB at CF-KAN-1's encoder
// and decoder shapes, a few microseconds of traffic.
#include "cim_mac_common.cuh"

namespace {

// out[i] = sum over p in order of parts_out[p * n + i]
__global__ void cim_mac_sum_parts(const float* __restrict__ parts_out,
                                  float* __restrict__ out, int parts,
                                  long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s = __fadd_rn(s, parts_out[p * n + i]);
    out[i] = s;
  }
}

}  // namespace

// The f32 elements of scratch that cim_mac_launch needs for these shapes
// on the current device: parts * B * C where it splits the arrays into
// parts, else 0.
extern "C" long long cim_mac_scratch(int B, int R, int C, int array_size) {
  if (array_size < 1 || B == 0 || C == 0) return 0;
  int per = 0;
  const int parts = cim::split_arrays(B, R, C, array_size, &per);
  return parts > 1 ? (long long)parts * B * C : 0;
}

// v [B, R] f32, w [R, C] int8, atten [R] f32, out [B, C] f32, all
// contiguous on the device; scratch holds cim_mac_scratch(B, R, C,
// array_size) floats (null if that is 0). rows_iterated, if not null, is a
// device counter to which the launch adds the (batch row, row) pairs whose
// terms it formed: its live-row lists' lengths, padding included, times the
// batch rows of each list's group. Returns cudaGetLastError().
extern "C" int cim_mac_launch(const float* v, const int8_t* w,
                              const float* atten, float* out, float* scratch,
                              unsigned long long* rows_iterated, int B, int R,
                              int C, int array_size, float lsb,
                              void* stream) {
  if (array_size < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int per = 0;
  const int parts = cim::split_arrays(B, R, C, array_size, &per);
  if (parts == 0 || (parts > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cim::launch<false, true>(
      v, w, nullptr, atten, out, scratch, rows_iterated, B, R, C, array_size,
      lsb, parts, per, s);
  if (e != cudaSuccess || parts == 1) return (int)e;
  const long long n = (long long)B * C;
  const long long blocks = (n + 255) / 256;
  cim_mac_sum_parts<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0,
                      s>>>(scratch, out, parts, n);
  return (int)cudaGetLastError();
}
