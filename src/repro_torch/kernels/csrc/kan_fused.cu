// Fused KAN spline layer on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kan_fused.py::kan_fused
// (_kan_fused_kernel):
//   y[b, o] = scale[o] * sum_{i,s} E[b, i, s] * codes[i, s, o]
// where E is built on chip from x: q = floor((x - x_min) / step) clipped to
// [0, G*L - 1], seg = q >> LD, loc = q & (L - 1), and the K+1 SH-LUT taps
// (reversed when loc >= ceil(L/2)) land in basis slots seg .. seg+K.
//
// Exact products in bf16. The codes are int8, and every int8 is exact in
// bf16. Each f32 tap t is split once per block into three bf16 pieces,
// hi = bf16(t), mid = bf16(t - hi), lo = t - hi - mid, whose sum is t
// exactly (lo is exact in bf16: a normal f32 has 24 significant bits, each
// piece takes 8). So every product on the tensor cores is exact, and the
// result differs from the plain f32 version only in the order of its f32
// sums. Built without fast math, so no subtraction is contracted into an
// FMA.
//
// What bounds it on this card: the exact result needs 3 * 2 * nnz(E) * O
// bf16 flops (10.9 GFLOP per CF-KAN-1 layer at B=256: 11 us at 989
// TFLOP/s) against about 34.6 MB moved (10 us at 3.35 TB/s). The kernel
// runs the dense E tile (S slots per input, K+1 of them nonzero; 2.5x the
// useful products at CF-KAN-1's S = 10) through mma.sync.m16n8k16, whose
// issue rate, not memory, is its limit; wgmma would raise it.
//
// Design: a block owns a (128 x 128) output tile. The contraction runs
// over the flattened (i, s) axis in k-blocks of 64 (four MMA k-steps of
// 16), so S need not divide 16. The block's warps are specialised and meet
// at named barriers over two slots:
//  * 8 producer warps keep the next k-block's int8 code tile [64 x 128] in
//    flight by cp.async (16-byte copies when O is a multiple of 16, else 4-
//    or 1-byte), widen the landed tile to bf16 in a slot (exact), and for
//    each (b, i) the k-block touches compute the input code once
//    (__fsub_rn, __fdiv_rn, floorf, clip, as the reference) into one int:
//    seg, and the row of the split tap table;
//  * 8 consumer warps, 16 rows by 128 columns each, build their A fragments
//    in registers, one per split plane (slot s of input i holds tap s - seg
//    when 0 <= s - seg <= K, else 0; E never reaches device memory, as on
//    the TPU), read the B fragments with ldmatrix.trans, and run three MMAs
//    (hi, mid, lo) per (A, B) pair from zero; each k-step's result is added
//    into an f32 accumulator (round to nearest), and every two k-blocks the
//    accumulator into the thread's f64 sums in shared memory.
// The short MMA chains and the f64 sums keep the result within the plain
// version's bar at CF-KAN-1's 163,840 slots: one f32 accumulator stepping
// 16 slots at a time drifts from the exact sum by several times the bar on
// these sizes, f32 partial sums of the splits by about the bar itself, and
// the tensor cores' own accumulation, carried over two k-blocks, by most
// of it.
// Ragged B, I, O and k edges are masked, not padded in memory: masked rows
// and slots give zero A entries, and any int8 left in a masked B entry is
// finite. When the output tiles alone do not fill the SMs (the encoder's
// 256 x 108 output is two tiles), the k-blocks are split over about one
// block per SM; each split writes its f64 sums to a scratch buffer that the
// caller allocates, and a second small kernel adds the splits in a fixed
// order, rounds once to f32 and applies the scale. No atomics: two launches
// on the same inputs give bitwise equal outputs. Without a split, the
// rounding and the scale are the epilogue.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;       // 8 consumer warps, then 8 producer warps
constexpr int kThreads = kWarps * 32;
constexpr int kHalf = kThreads / 2;  // threads in each role
constexpr int kBM = 128;          // batch rows per block: 8 warps of 16
constexpr int kBN = 128;          // output columns per block and warp
constexpr int kTiles = kBN / 8;   // n8 tiles per consumer warp
constexpr int kBK = 64;           // flattened (i, s) slots per k-block
constexpr int kFlush = 2;         // k-blocks per f32 accumulator run
constexpr int kBsStride = kBN + 8;  // bf16 B row, padded against conflicts
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kMasked = 0x7FFF;   // seg of a masked (b, i)
constexpr int kNoSlot = 0x4000;   // s of a masked k: s - seg never a tap
// named barriers: the producers among themselves; a slot is full (the
// producers arrive, the consumers wait) or empty (the other way round)
constexpr int kBarProducers = 1, kBarFull = 2, kBarEmpty = 4;

constexpr size_t kSumBytes = size_t(kHalf) * kTiles * 4 * 8;
constexpr size_t kBsBytes = size_t(kBK) * kBsStride * 2;
constexpr size_t kStageBytes = size_t(2) * kBK * kBN;
constexpr size_t kMapBytes = size_t(kBK) * 4;

__host__ __device__ inline int span_max(int S) { return (kBK - 1) / S + 2; }

// the fixed part, then the split tap table of L * (K+1) entries of 8 bytes,
// sized from the config (kernels/kan_fused.py::smem_bytes mirrors this)
inline size_t smem_bytes(int S, int L, int k1) {
  return kSumBytes + 2 * (kBsBytes + kMapBytes) + kStageBytes +
         2 * size_t(kBM) * span_max(S) * 4 + size_t(L) * k1 * 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int V>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else if constexpr (V == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else
    *static_cast<int8_t*>(dst) = *static_cast<const int8_t*>(src);
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// two int8 -> a bf16x2 word; exact: f32 by the 1.5 * 2^23 trick (its ulp
// is 1), then an 8-bit integer rounds to itself in bf16
__device__ __forceinline__ unsigned widen2(int c0, int c1) {
  const float f0 = __int_as_float(0x4B400000 + c0) - 12582912.0f;
  const float f1 = __int_as_float(0x4B400000 + c1) - 12582912.0f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One (128 x 128) output tile over k-blocks [kb_begin, kb_end). With
// partial == nullptr it writes y = f32(sum) * scale; else the split's f64
// sums, unscaled, at partial[(split * B + b) * O + o].
//
// Warp-specialised: the producer warps keep the codes of the next k-block
// in flight (cp.async) and fill slot n % 2 for k-block n (codes widened to
// bf16, slot map, input codes); the consumer warps build A and run the
// MMAs on the other slot meanwhile. Consumer warp w owns rows 16w .. 16w+15
// and all 128 columns; its f64 sums live in shared memory and take one
// run of kFlush k-blocks of f32 MMA accumulation at a time.
template <int V>
__global__ void __launch_bounds__(kThreads, 1)
kan_fused_mma(const float* __restrict__ x, const int8_t* __restrict__ codes,
              const float* __restrict__ scale,
              const float* __restrict__ hemi, float* __restrict__ y,
              double* __restrict__ partial, int B, int I, int S, int O,
              int k1, int ld, int n_levels, int half, float x_min,
              float step, int kb_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int smax = span_max(S);
  double* sums = reinterpret_cast<double*>(smem);
  unsigned char* rest = smem + kSumBytes;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(rest);
  int8_t* stage = reinterpret_cast<int8_t*>(rest + 2 * kBsBytes);
  int* kmap = reinterpret_cast<int*>(rest + 2 * kBsBytes + kStageBytes);
  int* ent = kmap + 2 * kBK;
  uint2* tab = reinterpret_cast<uint2*>(ent + 2 * kBM * smax);  // 8-aligned

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;
  const int L = 1 << ld;
  const int KT = I * S;
  const int n_kb = (KT + kBK - 1) / kBK;
  const int kb_begin = split * kb_per_split;
  const int count = min(n_kb, kb_begin + kb_per_split) - kb_begin;

  // the full tap table, reflection applied, each tap split into three
  // bf16 pieces: tab[loc * k1 + tt] = {hi | mid << 16, lo}
  for (int j = tid; j < L * k1; j += kThreads) {
    const int loc = j / k1, tt = j % k1;
    const bool refl = loc >= half;
    const float tp =
        hemi[(refl ? L - 1 - loc : loc) * k1 + (refl ? k1 - 1 - tt : tt)];
    const __nv_bfloat16 hi = __float2bfloat16_rn(tp);
    const float r1 = __fsub_rn(tp, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const __nv_bfloat16 lo =
        __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    tab[j] = make_uint2(
        (unsigned)__bfloat16_as_ushort(hi) |
            ((unsigned)__bfloat16_as_ushort(mid) << 16),
        (unsigned)__bfloat16_as_ushort(lo));
  }
  __syncthreads();

  if (warp >= kWarps / 2) {
    // ---- producers --------------------------------------------------------
    const int pt = tid - kHalf;
    // copies the int8 code tile of k-block n into stage buffer n & 1
    auto load_codes = [&](int n) {
      int8_t* dst = stage + (n & 1) * (kBK * kBN);
      const int k0 = (kb_begin + n) * kBK;
      constexpr int per_row = kBN / V;
      for (int j = pt; j < kBK * per_row; j += kHalf) {
        const int r = j / per_row, c = (j % per_row) * V;
        if (k0 + r < KT && n0 + c < O)
          copy_async<V>(dst + r * kBN + c,
                        codes + (size_t)(k0 + r) * O + n0 + c);
      }
      if constexpr (V > 1) copy_commit();
    };
    // the inputs k-block n touches: i_lo and how many
    auto span_of = [&](int n, int& i_lo) {
      const int k0 = (kb_begin + n) * kBK;
      i_lo = k0 / S;
      return min(k0 + kBK - 1, KT - 1) / S - i_lo + 1;
    };
    // x values of k-block n's (b, i), the first kPre of this thread's
    constexpr int kPre = 4;
    float xpre[kPre];
    auto load_x = [&](int n) {
      int i_lo;
      const int span = span_of(n, i_lo);
#pragma unroll
      for (int q = 0; q < kPre; ++q) {
        const int j = pt + q * kHalf;
        const int m = j / span, il = j % span;
        xpre[q] = (j < kBM * span && m0 + m < B)
                      ? x[(size_t)(m0 + m) * I + i_lo + il] : 0.f;
      }
    };

    if (count > 0) {
      load_codes(0);
      load_x(0);
    }
    for (int n = 0; n < count; ++n) {
      const int slot = n & 1;
      if constexpr (V > 1) copy_wait();
      bar_sync(kBarProducers, kHalf);  // stage n landed; stage n+1 is free
      if (n + 1 < count) load_codes(n + 1);
      if (n >= 2) bar_sync(kBarEmpty + slot, kThreads);  // consumed n - 2
      {  // 64 rows x 128 columns, 32 per thread; exact
        const int r = pt >> 2, c = (pt & 3) * 32;
        const int8_t* src = stage + slot * (kBK * kBN) + r * kBN + c;
        uint4* dst = reinterpret_cast<uint4*>(
            bs + slot * (kBK * kBsStride) + r * kBsStride + c);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 w = reinterpret_cast<const uint4*>(src)[q];
          const unsigned ws[4] = {w.x, w.y, w.z, w.w};
          unsigned out[8];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const unsigned v = ws[h];  // four codes, column order low first
            out[2 * h] = widen2((int)(v << 24) >> 24, (int)(v << 16) >> 24);
            out[2 * h + 1] = widen2((int)(v << 8) >> 24, (int)v >> 24);
          }
          dst[2 * q] = make_uint4(out[0], out[1], out[2], out[3]);
          dst[2 * q + 1] = make_uint4(out[4], out[5], out[6], out[7]);
        }
      }
      int i_lo;
      const int span = span_of(n, i_lo);
      if (pt < kBK) {
        const int k = (kb_begin + n) * kBK + pt;
        kmap[slot * kBK + pt] =
            k < KT ? (k / S - i_lo) | ((k % S) << 16) : (kNoSlot << 16);
      }
      int* es = ent + slot * (kBM * smax);
      auto put = [&](int j, float xv) {
        const int m = j / span, il = j % span;
        int e = kMasked;
        if (m0 + m < B) {
          // an f32 subtract and a true f32 divide, as the reference
          float qf = floorf(__fdiv_rn(__fsub_rn(xv, x_min), step));
          qf = fminf(fmaxf(qf, 0.f), (float)(n_levels - 1));
          const int qi = (int)qf;
          e = (qi >> ld) | (((qi & (L - 1)) * k1) << 16);
        }
        es[m * smax + il] = e;
      };
#pragma unroll
      for (int q = 0; q < kPre; ++q)
        if (pt + q * kHalf < kBM * span) put(pt + q * kHalf, xpre[q]);
      for (int j = pt + kPre * kHalf; j < kBM * span; j += kHalf) {
        const int m = j / span, il = j % span;
        put(j, m0 + m < B ? x[(size_t)(m0 + m) * I + i_lo + il] : 0.f);
      }
      bar_arrive(kBarFull + slot, kThreads);
      if (n + 1 < count) load_x(n + 1);
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp * 16;
  const bool warp_live = m0 + wm < B;
  float acc[kTiles][4];
  double* my_sums = sums + warp * (kTiles * 4 * 32) + lane;  // [j][h] * 32
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      acc[j][h] = 0.f;
      my_sums[(j * 4 + h) * 32] = 0.0;
    }
  const int er0 = (wm + g) * smax, er1 = er0 + 8 * smax;
  const int mi = lane >> 3;  // the 8x8 matrix this lane addresses

  for (int n = 0; n < count; ++n) {
    const int slot = n & 1;
    bar_sync(kBarFull + slot, kThreads);
    if (warp_live) {
      const int* km_s = kmap + slot * kBK;
      const int* es = ent + slot * (kBM * smax);
      const __nv_bfloat16* bsl = bs + slot * (kBK * kBsStride);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A fragments: rows g and g+8 of the warp, slots 2t, 2t+1, 2t+8,
        // 2t+9 of this k-step, one fragment per split plane
        const int2 kmA = *reinterpret_cast<const int2*>(km_s + kk * 16 + 2 * t);
        const int2 kmB =
            *reinterpret_cast<const int2*>(km_s + kk * 16 + 2 * t + 8);
        const int km[4] = {kmA.x, kmA.y, kmB.x, kmB.y};
        uint2 v[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = es[(r ? er1 : er0) + (km[c] & 0xFFFF)];
            const unsigned tp = (unsigned)((km[c] >> 16) - (e & 0xFFFF));
            v[r][c] = tp < (unsigned)k1 ? tab[(e >> 16) + tp]
                                        : make_uint2(0u, 0u);
          }
        unsigned a[3][4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint2 p = v[f & 1][(f >> 1) * 2];
          const uint2 q = v[f & 1][(f >> 1) * 2 + 1];
          a[0][f] = __byte_perm(p.x, q.x, 0x5410);
          a[1][f] = __byte_perm(p.x, q.x, 0x7632);
          a[2][f] = __byte_perm(p.y, q.y, 0x5410);
        }
        // B fragments of four n8 tiles per two ldmatrix.x4.trans; the three
        // planes go into a fresh f32 sum per tile, which is then added to
        // the accumulator with a round-to-nearest add: the tensor cores' own
        // accumulation is not round-to-nearest, and its error grows with
        // the length of the chain it carries
        const __nv_bfloat16* brow =
            bsl + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kBsStride +
            (mi >> 1) * 8;
#pragma unroll
        for (int jq = 0; jq < kTiles / 4; ++jq) {
          if (n0 + jq * 32 < O) {  // warp-uniform: skip tiles past O
            unsigned b[8];
#pragma unroll
            for (int u = 0; u < 2; ++u)
              asm volatile(
                  "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                  "{%0,%1,%2,%3}, [%4];\n"
                  : "=r"(b[4 * u]), "=r"(b[4 * u + 1]), "=r"(b[4 * u + 2]),
                    "=r"(b[4 * u + 3])
                  : "r"(smem_addr(brow + jq * 32 + u * 16)));
            float d[4][4] = {};
#pragma unroll
            for (int pl = 0; pl < 3; ++pl)
#pragma unroll
              for (int h = 0; h < 4; ++h)
                if (n0 + jq * 32 + h * 8 < O)
                  mma_bf16(d[h], a[pl], b[2 * h], b[2 * h + 1]);
#pragma unroll
            for (int h = 0; h < 4; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[4 * jq + h][e] = __fadd_rn(acc[4 * jq + h][e], d[h][e]);
          }
        }
      }
    }
    if (n + 2 < count) bar_arrive(kBarEmpty + slot, kThreads);
    if (warp_live && (n % kFlush == kFlush - 1 || n + 1 == count)) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
        if (n0 + j * 8 < O)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            my_sums[(j * 4 + h) * 32] += (double)acc[j][h];
            acc[j][h] = 0.f;
          }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int b = m0 + wm + g + (h >> 1) * 8;
      const int o = n0 + j * 8 + 2 * t + (h & 1);
      const double sv = my_sums[(j * 4 + h) * 32];
      if (b < B && o < O) {
        if (partial == nullptr)
          y[(size_t)b * O + o] = (float)sv * scale[o];
        else
          partial[((size_t)split * B + b) * O + o] = sv;
      }
    }
  }
}

// y[b, o] = f32(sum over splits, in split order) * scale[o]
__global__ void kan_fused_reduce(const double* __restrict__ partial,
                                 const float* __restrict__ scale,
                                 float* __restrict__ y, int B, int O,
                                 int n_split) {
  const size_t n = (size_t)B * O;
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (size_t)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int p = 0; p < n_split; ++p) s += partial[(size_t)p * n + j];
    y[j] = (float)s * scale[j % O];
  }
}

struct Plan {
  dim3 grid;
  int kb_per_split, n_split;
};

// Output tiles first; when they are fewer than the current device's SMs,
// the k-blocks are split so that the grid holds about one block per SM.
cudaError_t plan(int B, int I, int S, int O, Plan* p) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tn = (O + kBN - 1) / kBN, tm = (B + kBM - 1) / kBM;
  const long long n_kb = ((long long)I * S + kBK - 1) / kBK;
  long long want = 1;
  if ((long long)tn * tm < n_sm)
    want = (n_sm + (long long)tn * tm - 1) / ((long long)tn * tm);
  want = want < n_kb ? want : n_kb;
  const int per = (int)((n_kb + want - 1) / want);
  const int n_split = (int)((n_kb + per - 1) / per);
  *p = Plan{dim3(tn, tm, n_split), per, n_split};
  return cudaSuccess;
}

template <int V>
int launch(const Plan& p, const float* x, const int8_t* codes,
           const float* scale, const float* hemi, float* y, double* scratch,
           int B, int I, int S, int O, int k1, int ld, int n_levels,
           int half, float x_min, float step, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, 1 << ld, k1);
  cudaError_t err = cudaFuncSetAttribute(
      kan_fused_mma<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  double* partial = p.n_split > 1 ? scratch : nullptr;
  kan_fused_mma<V><<<p.grid, kThreads, smem, stream>>>(
      x, codes, scale, hemi, y, partial, B, I, S, O, k1, ld, n_levels, half,
      x_min, step, p.kb_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return (int)err;
  const long long n = (long long)B * O;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  kan_fused_reduce<<<blocks, 256, 0, stream>>>(partial, scale, y, B, O,
                                               p.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// f64 elements of the scratch buffer kan_fused_launch needs for these
// shapes on the current device (0 when the output tiles alone fill it), or
// minus the CUDA error when the device cannot be asked.
extern "C" long long kan_fused_scratch(int B, int I, int S, int O) {
  Plan p;
  const cudaError_t err = plan(B, I, S, O, &p);
  if (err != cudaSuccess) return -(long long)err;
  return p.n_split > 1 ? (long long)p.n_split * B * O : 0;
}

// x [B, I] f32, codes [I, S, O] int8, scale [O] f32, hemi [half, k1] f32,
// y [B, O] f32, scratch kan_fused_scratch(B, I, S, O) f64 (may be null when
// that is 0), all contiguous on the current device. Any K and L whose tap
// table fits in shared memory beside the rest of the block's (L * (K+1) <=
// 5184 at S = 10). Returns the first CUDA error, else cudaGetLastError().
extern "C" int kan_fused_launch(const float* x, const int8_t* codes,
                                const float* scale, const float* hemi,
                                float* y, double* scratch, int B, int I, int S,
                                int O, int k1, int ld, int n_levels, int half,
                                float x_min, float step, void* stream) {
  if (k1 < 1 || ld < 0 || ld > 14 || S < k1 || S < 2 || S >= kNoSlot ||
      B < 1 || I < 1 || O < 1 || (long long)I * S > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int L = 1 << ld;
  if (half != (L + 1) / 2 || smem_bytes(S, L, k1) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan(B, I, S, O, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.n_split > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  if (O % 16 == 0 && base % 16 == 0)
    return launch<16>(p, x, codes, scale, hemi, y, scratch, B, I, S, O, k1,
                      ld, n_levels, half, x_min, step, s);
  if (O % 4 == 0 && base % 4 == 0)
    return launch<4>(p, x, codes, scale, hemi, y, scratch, B, I, S, O, k1,
                     ld, n_levels, half, x_min, step, s);
  return launch<1>(p, x, codes, scale, hemi, y, scratch, B, I, S, O, k1, ld,
                   n_levels, half, x_min, step, s);
}
