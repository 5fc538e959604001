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
// inputs): every product and sum is one __fmul_rn / add.rn, never an FMA.
//
// Three identities make the design below exact:
//  (a) a row with fl(v * atten) = 0 adds +-0 to a finite psum, which leaves
//      it as it was (a psum is never -0: it starts at +0, and x + (-x) is
//      +0 under round to nearest), so rows dead for a batch row are skipped;
//  (b) the sign is folded into the gain once per cell, fl(va * (-g)) being
//      the reference's own product va * (sign * gain);
//  (c) codes are integers and their sum over row tiles is exact in uint32
//      in any order, so row tiles may be split across blocks and reduced
//      with atomics into a zeroed output and stay bitwise repeatable.
//
// What bounds it on this card: each tile's eight bit-slice sums must be
// complete, in row order, before the ADC reads them, so the MAC cannot
// become a matrix product (an MMA would not round as an in-order sum of
// per-cell gain products does). The work is one f32 multiply per live
// (b, r, c) and one add per set bit, issued as a predicated add per bit
// plane: instruction issue, not bytes, is the limit, and the kernel stays
// well above its operation bound because unset bits still issue.
//
// Design. A block owns a group of kGroup = 16 batch rows, 128 columns (one
// per lane of 4 column warps; 2 batch warps of kTM = 8 rows each) and a
// run of row tiles.
//  1. Live-row list. Per chunk of up to kChunk = 256 rows of a tile, the
//     block forms fl(v * atten) for its 16 batch rows and lists, in shared
//     memory and in row order (ballot and popc prefix sums over 32-row
//     groups), the rows live for any of them, with their values; the
//     CF-KAN inputs leave ~41% (encoder) and ~34% (decoder) of rows listed.
//     The next chunk's inputs arrive by cp.async while this one is summed.
//  2. The inner loop walks the list only, with no branch between a row's
//     loads: the codes and gains of the next kAhead rows are loaded while
//     the current ones are summed (the list is padded with rows of va = 0,
//     exact by (a)). Per listed row a thread forms fl(va * +-g) once per
//     batch row (a broadcast read of va) and adds it to bit planes 0..5
//     with predicated add.rn (one predicate per plane and row, shared by
//     its 8 batch rows). Planes 6 and 7, rare in ASP codes in [-127, 127]
//     (7 only by -128), are added only where a lane of the warp has them
//     (a warp-uniform test of the OR of the warp's 32 codes), each plane's
//     rows still in row order.
//  3. psums stay in registers across chunks. At the tile's end the ADC
//     reads each plane the warp met (a plane it never met holds +0 and
//     reads 0): q = psum * RN(1/lsb) rounds to rintf(__fdiv_rn(psum,
//     lsb)) wherever it lies farther than |q| * 2^-20 from every
//     half-integer, and __fdiv_rn decides elsewhere (adc_code has the
//     proof); a divide per readout cost 15% more. Codes gather in shared
//     memory, and go out by a store or, where the row tiles were split,
//     by atomicAdd (c). A launch can count the (batch row, row) pairs
//     whose terms it formed (rows_iterated).
//  4. Filling the card: CF-KAN-1's encoder has 16 x 1 blocks of (batch,
//     column), its decoder 16 x 128; the launch splits the row tiles into
//     parts of equal tile counts until there are ~32 blocks per SM.
//
// Tried and lost: the first design of this kernel skipped zero-code rows
// with a branch between a row's loads (16.86 + 9.08 ms per CF-KAN-1 apply
// at As 256, against 11.01 + 7.56 for the design that issued every row,
// which this one replaces; PERF.md). While building this one, these were
// each slower or level: accumulators in registers (they spilled at the
// 128-register cap of two blocks per SM), two rows loaded ahead instead of
// four, a per-row branch for planes 6 and 7, votes in place of the OR, and
// fewer blocks per SM. Loading a chunk's inputs only when its list was
// built cost the encoder more than anything but the adds. An earlier ADC
// ran div.rn's own steps with its reciprocal hoisted and one correction
// step fewer, whose agreement with __fdiv_rn nothing proved; adc_code's
// margin test replaced it (PERF.md has the times of all three).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The blocking. tests/test_torch_cim_tiled_order.py reads kGroup, kChunk
// and kAhead from the lines below to rehearse this order on the CPU.
constexpr int kWarps = 8;
constexpr int kColWarps = 4;                    // 128 columns per block
constexpr int kTM = 8;                          // batch rows per thread
constexpr int kGroup = 16;                      // batch rows per block
constexpr int kChunk = 256;                     // rows per list
constexpr int kAhead = 4;                       // rows loaded ahead
static_assert(kGroup == (kWarps / kColWarps) * kTM, "one row per thread");
static_assert(kChunk == 32 * kWarps, "one list row per thread");
constexpr int kBlocksPerSm = 32;                // when splitting row tiles
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

// (int) rintf(__fdiv_rn(a, lsb)), where adc_code cannot decide alone
__device__ __noinline__ int adc_exact(float a, float lsb) {
  return (int)rintf(__fdiv_rn(a, lsb));
}

// The ADC, rint(RN(a / lsb)) half to even, without a divide. y = RN(1/lsb)
// and q = RN(a * y) give |q - a/lsb| <= |a/lsb| * (2^-23 + 2^-48), and
// RN(a / lsb) is within |a/lsb| * 2^-24 of a/lsb: the two differ by less
// than |q| * 2^-22. Where no half-integer lies within |q| * 2^-20 of q,
// none lies between them and both round to rint(q). Elsewhere, and where
// y or q leave the ranges this needs (lsb_ok: 2^-120 <= lsb <= 2^120, so y
// is normal; |q| < 2^22, so q - rint(q) is exact; NaN and inf fail it too),
// __fdiv_rn decides. A q that underflowed is < 0.5 off zero, as is a/lsb.
__device__ __forceinline__ int adc_code(float a, float y, float lsb,
                                        bool lsb_ok) {
  const float q = __fmul_rn(a, y);
  const float n = rintf(q);
  const float to_half = fabsf(__fsub_rn(fabsf(__fsub_rn(q, n)), 0.5f));
  const bool clear = lsb_ok && fabsf(q) < 0x1p22f &&
                     to_half > __fmul_rn(fabsf(q), 0x1p-20f);
  return clear ? (int)n : adc_exact(a, lsb);
}

template <bool kGain>
__global__ void __launch_bounds__(kWarps * 32, 2)
cim_mac_tiled_kernel(const float* __restrict__ v,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ gain,
                     const float* __restrict__ atten,
                     int32_t* __restrict__ out,
                     unsigned long long* __restrict__ rows_iterated, int B,
                     int R, int C, int As, float lsb, int tiles_per_part) {
  __shared__ __align__(16) float va_s[kChunk + 2 * kAhead][kGroup];
  __shared__ float v_s[kGroup][kChunk];
  __shared__ float at_s[kChunk];
  __shared__ uint32_t acc_s[kWarps][kTM][32];
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
  const int t_begin = blockIdx.z * tiles_per_part;
  const int n_tiles = min(R / As - t_begin, tiles_per_part);
  const int per_tile = (As + kChunk - 1) / kChunk;
  const int n_chunks = max(n_tiles, 0) * per_tile;

  // chunk q's attenuation and inputs for the block's batch rows, by
  // cp.async: each thread copies (and later reads) its own row
  auto stage = [&](int q) {
    const int t = t_begin + q / per_tile;
    const int r = t * As + (q % per_tile) * kChunk + tid;
    const bool ok = r < (t + 1) * As;
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
  for (int m = 0; m < kTM; ++m) acc_s[warp][m][lane] = 0u;

  float ps[8][kTM];                     // [bit][batch row]
  unsigned planes = 0u;                 // bit planes the warp met (uniform)
  unsigned long long iterated = 0;      // listed rows, padding included
  for (int q = 0; q < n_chunks; ++q) {
    const int part = q % per_tile;
    if (part == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int m = 0; m < kTM; ++m) ps[k][m] = 0.f;
      planes = 0u;
    }
    const int r0 = (t_begin + q / per_tile) * As + part * kChunk;

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
    // with the chunk's first row at va = 0 (exact by (a))
    const int n_pad = (n_live + kAhead - 1) / kAhead * kAhead;
    iterated += n_pad;
    if (tid < n_pad + kAhead - n_live) {
      row_s[n_live + tid] = r0;
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

    // 3. at the tile's end, its ADC readout: code_k = rint(psum_k / lsb);
    // a plane the warp never met reads 0
    if (part == per_tile - 1) {
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
        uint32_t sum = 0u;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (!((planes >> k) & 1u)) continue;
          const int code = adc_code(ps[k][m], lsb_inv, lsb, lsb_ok);
          sum += (uint32_t)code << k;
        }
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
    int32_t* o = out + (size_t)b * C + c;
    if (gridDim.z == 1)
      *o = (int32_t)acc_s[warp][m][lane];
    else
      atomicAdd(reinterpret_cast<unsigned*>(o), acc_s[warp][m][lane]);  // (c)
  }
}

}  // namespace

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
  int dev = 0, n_sm = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long gx = (B + kGroup - 1) / kGroup;
  const long long gy = (C + 32 * kColWarps - 1) / (32 * kColWarps);
  if (gx * gy > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_tiles = R / array_size;
  // split the row tiles into parts of equal tile counts until there are
  // about kBlocksPerSm blocks per SM
  long long parts = (kBlocksPerSm * (long long)n_sm + gx * gy - 1) /
                    (gx * gy);
  parts = parts > n_tiles ? n_tiles : parts;
  parts = parts < 1 ? 1 : parts;
  const int per = (int)((n_tiles + parts - 1) / parts);
  parts = n_tiles > 0 ? (n_tiles + per - 1) / per : 1;
  if (parts > 1) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, (size_t)B * C * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(gx * gy), 1, (unsigned)parts);
  const dim3 block(32, kWarps);
  if (gain != nullptr)
    cim_mac_tiled_kernel<true><<<grid, block, 0, s>>>(
        v, w, gain, atten, out, rows_iterated, B, R, C, array_size, lsb, per);
  else
    cim_mac_tiled_kernel<false><<<grid, block, 0, s>>>(
        v, w, gain, atten, out, rows_iterated, B, R, C, array_size, lsb, per);
  return (int)cudaGetLastError();
}
