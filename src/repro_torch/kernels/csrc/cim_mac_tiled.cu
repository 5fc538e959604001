// Multi-tile RRAM-ACIM crossbar MAC with per-cell conductance gain and an
// integer digital reduction across row tiles, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cim_mac.py::cim_mac_tiled
// (_cim_mac_tiled_kernel). For each row tile of As rows, each output (b, c)
// and each bit k < 8:
//   term    = fl(fl(v[b, r] * atten[r]) * (sign(w[r, c]) * gain[r, c]))
//   psum_k  = sum over the tile's rows r whose bit k of |w[r, c]| is set,
//             in increasing row order
//   code_k  = (int) rint(psum_k / lsb)        (half to even, as jnp.round)
//   out[b, c] = sum_tiles sum_k code_k << k   (int32)
// with lsb = As * in_scale / (2^adc_bits - 1), computed by the caller. The
// codes equal kernels/ref.py's cim_mac_tiled_ref bit for bit (finite
// inputs).
//
// The kernel is cim_mac_common.cuh's, with the gain (or ideal cells) and
// int32 codes: what bounds it and its design are written there. Row tiles
// split across blocks add their codes into a zeroed output by int32
// atomics, exact in any order (identity (c) there).
#include "cim_mac_common.cuh"

// v [B, R] f32, w [R, C] int8, gain [R, C] f32 or null (ideal cells),
// atten [R] f32, out [B, C] int32, all contiguous on the device; R a
// multiple of array_size. rows_iterated, if not null, is a device counter
// to which the launch adds the (batch row, row) pairs whose terms it
// formed: its live-row lists' lengths, padding included, times the batch
// rows of each list's group. Returns cudaGetLastError().
extern "C" int cim_mac_tiled_launch(const float* v, const int8_t* w,
                                    const float* gain, const float* atten,
                                    int32_t* out,
                                    unsigned long long* rows_iterated, int B,
                                    int R, int C, int array_size, float lsb,
                                    void* stream) {
  if (array_size < 1 || R % array_size) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int per = 0;
  const int parts = cim::split_arrays(B, R, C, array_size, &per);
  if (parts == 0) return (int)cudaErrorInvalidValue;
  if (parts > 1) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, (size_t)B * C * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (gain != nullptr)
    return (int)cim::launch<true, false>(v, w, gain, atten, out, nullptr,
                                         rows_iterated, B, R, C, array_size,
                                         lsb, parts, per, s);
  return (int)cim::launch<false, false>(v, w, gain, atten, out, nullptr,
                                        rows_iterated, B, R, C, array_size,
                                        lsb, parts, per, s);
}
