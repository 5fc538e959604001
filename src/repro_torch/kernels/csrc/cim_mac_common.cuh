// The shared body of the two bit-sliced RRAM-ACIM crossbar MACs,
// hand-written for Hopper (sm_90a): cim_mac.cu (one monolithic array per
// As rows, f32 readouts) and cim_mac_tiled.cu (a grid of tiles with a
// per-cell gain and int32 codes) are two instantiations of the kernel
// below. For each physical array of As rows (the last one ragged where As
// does not divide R: its missing rows count as dead), each output (b, c)
// and each bit k < 8:
//   term    = fl(fl(v[b, r] * atten[r]) * (sign(w[r, c]) * gain[r, c]))
//             (gain 1 for ideal cells, where the term is +-fl(v * atten))
//   psum_k  = sum over the array's rows r whose bit k of |w[r, c]| is set,
//             in increasing row order
//   n_k     = rint(psum_k / lsb)         (half to even, as jnp.round)
// with lsb = As * in_scale / (2^adc_bits - 1), computed by the caller. The
// codes kernel sums n_k << k over arrays in int32; the readout kernel sums
// fl(2^k * fl(n_k * lsb)) over arrays in f32. Every product and sum above
// is one __fmul_rn / add.rn, never an FMA, so each n_k, and hence each
// readout, equals the plain versions' (kernels/ref.py) bit for bit for
// finite inputs.
//
// Four identities make the design below exact:
//  (a) a row with fl(v * atten) = 0 adds +-0 to a finite psum, which leaves
//      it as it was (a psum is never -0: it starts at +0, and x + (-x) is
//      +0 under round to nearest), so rows dead for a batch row are
//      skipped, and rows past R are dead rows;
//  (b) the sign is folded into the gain once per cell, fl(va * (-g)) being
//      the reference's own product va * (sign * gain);
//  (c) codes are integers and their sum over arrays is exact in uint32 in
//      any order, so arrays may be split across blocks and reduced with
//      atomics into a zeroed output and stay bitwise repeatable;
//  (d) f32 readouts are not: each part of the arrays writes its own sum to
//      a scratch slice, and the parts are added in part order afterwards
//      (cim_mac.cu), so the result is repeatable bit for bit too.
//
// What bounds it on this card: each array's eight bit-slice sums must be
// complete, in row order, before the ADC reads them, so the MAC cannot
// become a matrix product (an MMA would not round as an in-order sum
// does). The work is one f32 multiply per live (b, r, c) and one add per
// set bit, executed as a predicated add per bit plane: the instruction
// rate, not bytes, is the limit, and the kernel stays well above its
// operation bound because an unset bit still costs its predicated add.
//
// Design. A block owns a group of kGroup = 16 batch rows, 128 columns (one
// per lane of 4 column warps; 2 batch warps of kTM = 8 rows each) and a
// run of arrays.
//  1. Live-row list. Per chunk of up to kChunk = 256 rows of an array, the
//     block forms fl(v * atten) for its 16 batch rows and lists, in shared
//     memory and in row order (ballot and popc prefix sums over 32-row
//     groups), the rows live for any of them, with their values; the
//     CF-KAN inputs leave ~41% (encoder) and ~34% (decoder) of rows listed.
//     The next chunk's inputs arrive by cp.async while this one is summed.
//  2. The inner loop walks the list only, with no branch between a row's
//     loads: the codes (and gains) of the next kAhead rows are loaded
//     while the current ones are summed (the list is padded with rows of
//     va = 0, exact by (a)). Per listed row a thread forms fl(va * +-g)
//     once per batch row (a broadcast read of va) and adds it to bit
//     planes 0..5 with predicated add.rn (one predicate per plane and row,
//     shared by its 8 batch rows). Planes 6 and 7, rare in ASP codes in
//     [-127, 127] (7 only by -128), are added only where a lane of the
//     warp has them (a warp-uniform test of the OR of the warp's 32
//     codes), each plane's rows still in row order.
//  3. psums stay in registers across chunks. At the array's end the ADC
//     reads each plane the warp met (a plane it never met holds +0 and
//     reads 0): q = psum * RN(1/lsb) rounds to rintf(__fdiv_rn(psum,
//     lsb)) wherever it lies farther than |q| * 2^-20 from every
//     half-integer, and __fdiv_rn decides elsewhere (adc_round has the
//     proof); a divide per readout cost 14-17% more. The array's sum
//     gathers in shared memory and goes out at the end (c, d). A launch
//     can count the (batch row, row) pairs whose terms it formed
//     (rows_iterated).
//  4. Filling the card: CF-KAN-1's encoder has 16 x 1 blocks of (batch,
//     column), its decoder 16 x 128; the launch splits the arrays into
//     parts of equal array counts until there are ~kBlocksPerSm blocks per
//     SM (split_arrays). The encoder's 108 columns leave 20 lanes of its
//     one column block idle.
//
// Tried and lost (cim_mac_tiled): a branch that skipped zero-code rows
// between a row's loads (16.86 + 9.08 ms per CF-KAN-1 apply at As 256,
// against 11.01 + 7.56 for a design that summed every row; PERF.md). Each
// slower or level: accumulators in registers (they spilled at the
// 128-register cap of two blocks per SM), two rows loaded ahead instead of
// four, a per-row branch for planes 6 and 7, votes in place of the OR,
// fewer blocks per SM, and loading a chunk's inputs only when its list was
// built.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Each source that includes this header gets its own copy (an unnamed
// namespace): nothing here is linked across sources.
namespace cim {
namespace {

// The blocking. tests/test_torch_cim_tiled_order.py reads kColWarps,
// kGroup, kChunk, kAhead and kBlocksPerSm from the lines below to rehearse
// this order on the CPU.
constexpr int kWarps = 8;
constexpr int kColWarps = 4;                    // 128 columns per block
constexpr int kTM = 8;                          // batch rows per thread
constexpr int kGroup = 16;                      // batch rows per block
constexpr int kChunk = 256;                     // rows per list
constexpr int kAhead = 4;                       // rows loaded ahead
constexpr int kBlocksPerSm = 32;                // when splitting arrays
static_assert(kGroup == (kWarps / kColWarps) * kTM, "one row per thread");
static_assert(kChunk == 32 * kWarps, "one list row per thread");
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from src to dst, or 4 zero bytes when !ok (src is then not read)
__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(ok ? 4u : 0u));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ps[m] += t[m] for the 8 batch rows where `bit` (of the lane's magnitude)
// is set: one predicate, eight predicated add.rn (no branch)
__device__ __forceinline__ void add_plane(float (&ps)[kTM],
                                          const float (&t)[kTM],
                                          unsigned bit) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ne.u32 p, %8, 0;\n\t"
      "@p add.rn.f32 %0, %0, %9;\n\t"
      "@p add.rn.f32 %1, %1, %10;\n\t"
      "@p add.rn.f32 %2, %2, %11;\n\t"
      "@p add.rn.f32 %3, %3, %12;\n\t"
      "@p add.rn.f32 %4, %4, %13;\n\t"
      "@p add.rn.f32 %5, %5, %14;\n\t"
      "@p add.rn.f32 %6, %6, %15;\n\t"
      "@p add.rn.f32 %7, %7, %16;\n\t}"
      : "+f"(ps[0]), "+f"(ps[1]), "+f"(ps[2]), "+f"(ps[3]), "+f"(ps[4]),
        "+f"(ps[5]), "+f"(ps[6]), "+f"(ps[7])
      : "r"(bit), "f"(t[0]), "f"(t[1]), "f"(t[2]), "f"(t[3]), "f"(t[4]),
        "f"(t[5]), "f"(t[6]), "f"(t[7]));
}

// The 8 terms fl(va * sg) of listed row j for this thread's batch rows
__device__ __forceinline__ void terms(float (&tm)[kTM], const float* va,
                                      float sg) {
  const float4 a0 = reinterpret_cast<const float4*>(va)[0];
  const float4 a1 = reinterpret_cast<const float4*>(va)[1];
  tm[0] = __fmul_rn(a0.x, sg);
  tm[1] = __fmul_rn(a0.y, sg);
  tm[2] = __fmul_rn(a0.z, sg);
  tm[3] = __fmul_rn(a0.w, sg);
  tm[4] = __fmul_rn(a1.x, sg);
  tm[5] = __fmul_rn(a1.y, sg);
  tm[6] = __fmul_rn(a1.z, sg);
  tm[7] = __fmul_rn(a1.w, sg);
}

// rintf(__fdiv_rn(a, lsb)), where adc_round cannot decide alone
__device__ __noinline__ float adc_exact(float a, float lsb) {
  return rintf(__fdiv_rn(a, lsb));
}

// The ADC, rint(RN(a / lsb)) half to even, without a divide. y = RN(1/lsb)
// and q = RN(a * y) give |q - a/lsb| <= |a/lsb| * (2^-23 + 2^-48), and
// RN(a / lsb) is within |a/lsb| * 2^-24 of a/lsb: the two differ by less
// than |q| * 2^-22. Where no half-integer lies within |q| * 2^-20 of q,
// none lies between them and both round to rint(q). Elsewhere, and where
// y or q leave the ranges this needs (lsb_ok: 2^-120 <= lsb <= 2^120, so y
// is normal; |q| < 2^22, so q - rint(q) is exact; NaN and inf fail it too),
// __fdiv_rn decides. A q that underflowed is < 0.5 off zero, as is a/lsb.
// The integer comes back as a float: the readout kernel never converts it.
__device__ __forceinline__ float adc_round(float a, float y, float lsb,
                                           bool lsb_ok) {
  const float q = __fmul_rn(a, y);
  const float n = rintf(q);
  const float to_half = fabsf(__fsub_rn(fabsf(__fsub_rn(q, n)), 0.5f));
  const bool clear = lsb_ok && fabsf(q) < 0x1p22f &&
                     to_half > __fmul_rn(fabsf(q), 0x1p-20f);
  return clear ? n : adc_exact(a, lsb);
}

// kGain: a per-cell gain [R, C] (else ideal cells). kReadout: out is f32,
// the sum over arrays of fl(2^k * fl(n_k * lsb)), written to out when the
// arrays are not split, else each part's sum to parts_out[blockIdx.z];
// otherwise out is int32, the sum of n_k << k, stored or (split) added by
// atomics into a zeroed out.
template <bool kGain, bool kReadout>
__global__ void __launch_bounds__(kWarps * 32, 2)
mac_kernel(const float* __restrict__ v, const int8_t* __restrict__ w,
           const float* __restrict__ gain, const float* __restrict__ atten,
           std::conditional_t<kReadout, float, int32_t>* __restrict__ out,
           float* __restrict__ parts_out,
           unsigned long long* __restrict__ rows_iterated, int B, int R,
           int C, int As, float lsb, int arrays_per_part) {
  using Acc = std::conditional_t<kReadout, float, uint32_t>;
  __shared__ __align__(16) float va_s[kChunk + 2 * kAhead][kGroup];
  __shared__ float v_s[kGroup][kChunk];
  __shared__ float at_s[kChunk];
  __shared__ Acc acc_s[kWarps][kTM][32];
  __shared__ int row_s[kChunk + 2 * kAhead];
  __shared__ unsigned mask_s[kWarps];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int cw = warp % kColWarps, bw = warp / kColWarps;
  // blockIdx.x: batch group fastest, so that blocks running together
  // share their columns' codes and gains in L2
  const int n_groups = (B + kGroup - 1) / kGroup;
  const int b0 = (int)(blockIdx.x % n_groups) * kGroup;
  const int c = (int)(blockIdx.x / n_groups) * (32 * kColWarps) + cw * 32 +
                lane;
  const bool c_ok = c < C;
  const int cl = c_ok ? c : C - 1;      // a dead lane loads a real cell
  const int t_begin = blockIdx.z * arrays_per_part;
  const int n_arrays = min((R + As - 1) / As - t_begin, arrays_per_part);
  const int per_array = (As + kChunk - 1) / kChunk;
  const int n_chunks = max(n_arrays, 0) * per_array;

  // chunk q's attenuation and inputs for the block's batch rows, by
  // cp.async: each thread copies (and later reads) its own row; rows past
  // the array's end or past R read as zero (dead, by (a))
  auto stage = [&](int q) {
    const int t = t_begin + q / per_array;
    const int r = t * As + (q % per_array) * kChunk + tid;
    const bool ok = r < min((t + 1) * As, R);
    copy4(&at_s[tid], atten + (ok ? r : 0), ok);
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      const bool ld = ok && b0 + m < B;
      copy4(&v_s[m][tid], v + (ld ? (size_t)(b0 + m) * R + r : 0), ld);
    }
    copy_commit();
  };
  if (n_chunks > 0) stage(0);

  const float lsb_inv = __frcp_rn(lsb);
  const bool lsb_ok = lsb >= 0x1p-120f && lsb <= 0x1p120f;

#pragma unroll
  for (int m = 0; m < kTM; ++m) acc_s[warp][m][lane] = Acc(0);

  float ps[8][kTM];                     // [bit][batch row]
  unsigned planes = 0u;                 // bit planes the warp met (uniform)
  unsigned long long iterated = 0;      // listed rows, padding included
  for (int q = 0; q < n_chunks; ++q) {
    const int part = q % per_array;
    if (part == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int m = 0; m < kTM; ++m) ps[k][m] = 0.f;
      planes = 0u;
    }
    const int r0 = (t_begin + q / per_array) * As + part * kChunk;

    // 1. the list of the chunk's rows live for any batch row of the block
    copy_wait();
    float va[kGroup];
    bool live = false;
    const float at = at_s[tid];
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      va[m] = __fmul_rn(v_s[m][tid], at);
      live |= va[m] != 0.f;
    }
    const unsigned mask = __ballot_sync(kFull, live);
    if (lane == 0) mask_s[warp] = mask;
    __syncthreads();
    int before = 0, n_live = 0;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) {
      const int n = __popc(mask_s[g]);
      before += g < warp ? n : 0;
      n_live += n;
    }
    if (live) {
      const int pos = before + __popc(mask & ((1u << lane) - 1u));
      row_s[pos] = r0 + tid;
      float4* dst = reinterpret_cast<float4*>(va_s[pos]);
#pragma unroll
      for (int i = 0; i < kGroup / 4; ++i)
        dst[i] = make_float4(va[4 * i], va[4 * i + 1], va[4 * i + 2],
                             va[4 * i + 3]);
    }
    // pad to whole kAhead steps, plus kAhead rows for the last prefetch,
    // with a row of the array at va = 0 (exact by (a)): the chunk's first,
    // or R - 1 where a ragged array's chunk lies past R
    const int n_pad = (n_live + kAhead - 1) / kAhead * kAhead;
    iterated += n_pad;
    if (tid < n_pad + kAhead - n_live) {
      row_s[n_live + tid] = min(r0, R - 1);
#pragma unroll
      for (int m = 0; m < kGroup; ++m) va_s[n_live + tid][m] = 0.f;
    }
    __syncthreads();
    if (q + 1 < n_chunks) stage(q + 1);

    // 2. the listed rows, in row order, with kAhead rows' loads in flight
    const float* va_row = &va_s[0][bw * kTM];
    int cn[kAhead];
    float gn[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const size_t rc = (size_t)row_s[d] * C + cl;
      cn[d] = w[rc];
      gn[d] = kGain ? gain[rc] : 1.f;
    }
    for (int j = 0; j < n_pad; j += kAhead) {
      int cc[kAhead];
      float gc[kAhead];
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        cc[d] = cn[d];
        gc[d] = gn[d];
        const size_t rc = (size_t)row_s[j + kAhead + d] * C + cl;
        cn[d] = w[rc];
        gn[d] = kGain ? gain[rc] : 1.f;
      }
      unsigned mag[kAhead], orm[kAhead];
      float sg[kAhead];
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int code = c_ok ? cc[d] : 0;
        mag[d] = (unsigned)(code < 0 ? -code : code);
        sg[d] = code < 0 ? -gc[d] : gc[d];                  // (b)
        orm[d] = __reduce_or_sync(kFull, mag[d]);
        planes |= orm[d];
        float tm[kTM];
        terms(tm, va_row + (j + d) * kGroup, sg[d]);
#pragma unroll
        for (int k = 0; k < 6; ++k) add_plane(ps[k], tm, mag[d] & (1u << k));
      }
      // planes 6 and 7, rare in ASP codes, where a lane of the warp has
      // them; each plane's rows still in row order
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        if (orm[d] & 0xC0u) {
          float tm[kTM];
          terms(tm, va_row + (j + d) * kGroup, sg[d]);
          add_plane(ps[6], tm, mag[d] & 0x40u);
          add_plane(ps[7], tm, mag[d] & 0x80u);
        }
      }
    }

    // 3. at the array's end, its ADC readout: n_k = rint(psum_k / lsb);
    // a plane the warp never met reads 0
    if (part == per_array - 1) {
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
        Acc sum = Acc(0);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (!((planes >> k) & 1u)) continue;
          const float n = adc_round(ps[k][m], lsb_inv, lsb, lsb_ok);
          if constexpr (kReadout)
            sum = __fadd_rn(sum, __fmul_rn((float)(1 << k),
                                           __fmul_rn(n, lsb)));
          else
            sum += (uint32_t)(int)n << k;
        }
        if constexpr (kReadout)
          acc_s[warp][m][lane] = __fadd_rn(acc_s[warp][m][lane], sum);
        else
          acc_s[warp][m][lane] += sum;
      }
    }
  }

  // the (batch row, row) pairs whose terms the block formed, counted once
  // per batch group (by the first column block)
  if (rows_iterated != nullptr && tid == 0 && blockIdx.x < n_groups)
    atomicAdd(rows_iterated,
              iterated * (unsigned long long)min(kGroup, B - b0));
  if (!c_ok) return;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int b = b0 + bw * kTM + m;
    if (b >= B) continue;
    const size_t o = (size_t)b * C + c;
    if constexpr (kReadout) {
      if (gridDim.z == 1)
        out[o] = acc_s[warp][m][lane];
      else
        parts_out[(size_t)blockIdx.z * B * C + o] = acc_s[warp][m][lane];
    } else {
      if (gridDim.z == 1)
        out[o] = (int32_t)acc_s[warp][m][lane];
      else
        atomicAdd(reinterpret_cast<unsigned*>(out + o),
                  acc_s[warp][m][lane]);                         // (c)
    }
  }
}

// The split of the arrays over blocks: parts of equal array counts
// (*per each, the last one shorter) until there are about kBlocksPerSm
// blocks per SM. Returns the number of parts, 0 if the grid does not fit.
inline int split_arrays(int B, int R, int C, int As, int* per) {
  int dev = 0, n_sm = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long gx = (B + kGroup - 1) / kGroup;
  const long long gy = (C + 32 * kColWarps - 1) / (32 * kColWarps);
  if (gx * gy > 0x7fffffffLL) return 0;
  const int n_arrays = (R + As - 1) / As;
  long long parts = (kBlocksPerSm * (long long)n_sm + gx * gy - 1) /
                    (gx * gy);
  parts = parts > n_arrays ? n_arrays : parts;
  parts = parts < 1 ? 1 : parts;
  *per = (int)((n_arrays + parts - 1) / parts);
  return n_arrays > 0 ? (n_arrays + *per - 1) / *per : 1;
}

// Launch mac_kernel over `parts` parts of `per` arrays each.
template <bool kGain, bool kReadout>
cudaError_t launch(const float* v, const int8_t* w, const float* gain,
                   const float* atten,
                   std::conditional_t<kReadout, float, int32_t>* out,
                   float* parts_out, unsigned long long* rows_iterated,
                   int B, int R, int C, int As, float lsb, int parts,
                   int per, cudaStream_t s) {
  const long long gx = (B + kGroup - 1) / kGroup;
  const long long gy = (C + 32 * kColWarps - 1) / (32 * kColWarps);
  const dim3 grid((unsigned)(gx * gy), 1, (unsigned)parts);
  mac_kernel<kGain, kReadout><<<grid, dim3(32, kWarps), 0, s>>>(
      v, w, gain, atten, out, parts_out, rows_iterated, B, R, C, As, lsb,
      per);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cim
