// K5 sigma_cap: the sigma cap's power iteration, one launch per call.
//
// Replaces the sigma cap of a tracked rotation, dwavehmc_tpu/ops/
// tracked_eigh.py::_spectral_norm_est (XLA's matmul and jnp.sum; no Pallas).
// For every chain b of S = sr + i si (batch, n, n), with iters = 3:
//
//   v = (1/sqrt(n), 0);
//   iters times:  w = S v;  nrm = sqrt(sum_i |w_i|^2) + 1e-30;  v = w / nrm;
//   w = S v;  sigma = sqrt(sum_i |w_i|^2).
//
// Bits.  sigma equals ops/kernels.py::spectral_norm_est_plain bit for bit:
// 1/sqrt(n) as a correctly rounded square root and an IEEE division; each
// of the four dot products a row makes (sr.vr, si.vi, sr.vi, si.vr) and the
// norm's sum over i of wr*wr + wi*wi in the halving tree of
// halving_tree.cuh (zero-padded to P = tree_length(n), then x[i] + x[i + h]
// for h = P/2, ..., 1); w = (rr - ii, ri + ir); sqrt, + 1e-30 rounded to the
// type, IEEE divisions; every operation rounded on its own.  A chain's bits
// do not depend on the batch.
//
// The fold.  A level whose partners all lie past n adds zeros, and x + 0 = x,
// so the tree over P leaves is the tree over H = the largest power of two
// <= n (32 at least for a row, 64 for the norm) after one partial level,
// x[i] + x[i + H] for i < n - H.  The walk skips the padding leaves (44-48 %
// of the leaves at n = 1152, 4232 and 8464).  The one exception to x + 0 = x
// is -0 + 0 = +0: skipping a padding level can change only the sign of a
// sum that is exactly zero.  That sign reaches a w_i, then v_i = w_i / nrm
// and the next pass's products with it, all of them zeros of either sign,
// which change no nonzero sum; |w_i|^2 is +0 either way, so nrm and sigma
// do not see it.  The norm's terms are >= +0, so its fold is exact.
//
// Bound: bytes.  Each pass streams all of S, 2 n^2 values a chain, and the
// passes depend on each other through the norm: four reads of S from device
// memory at 3.35 TB/s, or one where S stays on chip (in L2, or in the CTAs'
// shared memory in the on-chip mode).  What holds a pass back is how many
// bytes each warp has in flight: a lane's leaves lie 128 bytes apart in
// bit-reversed order, so a load cannot be one wide copy, and every chunk of
// leaves is a round trip to memory.
//
// Design: one cooperative launch (every CTA resident) of C CTAs a chain, C
// any count the plan in ops/kernels.py chooses (the most with which the
// whole batch fits at once, else one a chain and the chains in turns).
// - A CTA is 16 warps at up to 128 registers a thread, one CTA an SM.  32
//   warps (64 registers) were measured too: with half the registers a lane
//   keeps fewer leaves in flight and spills, and every float32 shape but
//   8 x 512 ran slower (drivers/sigma_cap_variants.py).
//   Rows go to CTAs by their low index bits, i = r + C k, and to warps by
//   k; one warp a row.  Lane l holds leaf j = l + 32 q of the folded tree
//   (its x_j and, where j + H < n, x_{j+H}) and walks q in bit-reversed
//   order, G leaves a load straight into registers (no shared-memory
//   ring): 16 float, 8 double (4 where a row's partners x_{j+H} may fall
//   in any slot of a load); each leaf's products go into the chunk's
//   adjacent-pair levels as they are formed, the chunks are merged by a
//   binary counter, and the five lane levels are shuffles.  Where n is a
//   power of two or a little past one (every width the port runs but 2 x
//   20^2) the partners fall in the first kSlots slots of a load, so they
//   take few registers.
// - v lives in each CTA's shared memory as (vr, vi) pairs (2 n values; the
//   v_in_l2 mode, for rows too long for that, reads v_j = w_j / nrm from
//   L2 instead).  In the on-chip mode each CTA also copies its rows of S
//   into shared memory on pass 0 and reads them there on passes 1-3, so S
//   is read from device memory once (every chain at once, the rows beside
//   v in the CTAs' 227 KB each).
// - Where a warp streams many rows a pass, it first streams each row from
//   device memory into L2 in one bulk copy (cp.async.bulk.prefetch), so
//   memory sees the row in order; with few rows a warp, the copies of all
//   warps' rows at once overrun L2, and the plan leaves them out.
// - One barrier of the chain's CTAs a pass, on a counter in device memory:
//   each CTA computes v0 itself; a pass writes its unnormalized w rows into
//   a double-buffered scratch (pass p + 2 reuses p's buffer only after
//   every CTA has passed barrier p + 1) and arrives; after the barrier every
//   CTA reads all of w, adds the norm's tree itself and divides as it loads
//   v.  The last pass has no barrier: the chain's last CTA to arrive adds
//   the norm, writes sigma and zeroes the counter for the next call.  No
//   host sync and no host-side scalar.
// - Odd passes walk their rows backwards, so a pass starts on the rows the
//   last one left in L2.
// - sigma_cap_f64.cu compiles this file for double, so that both types
//   build at once.
#include <cuda_runtime.h>

#include "halving_tree.cuh"

namespace {

using namespace halving_tree;

// the most dynamic shared memory a block may use on Hopper
constexpr int kMaxSmem = 232448;

// The modes (ops/kernels.py SIGMA_CAP_MODES): S streamed from device memory
// every pass with v in shared memory; S's rows copied into shared memory on
// pass 0; S streamed with v read from L2.
constexpr int kStream = 0, kOnChip = 1, kVInL2 = 2;
// The longest rows each mode is built for: a lane's 2^LQ leaves, rows of
// n < 64 2^LQ.
constexpr int kMaxLQ = 10, kMaxOnChipLQ = 5;

template <typename T>
struct Cfg;
// A CTA's warps; the leaves a lane loads at once, by the row's flavor
// (kSparse, kDense); and the sparse flavor's partner slots
// (drivers/sigma_cap_variants.py times other values).
template <>
struct Cfg<float> {
  static constexpr int kWarps = 16, kSlots = 4;
  static constexpr int kGOf[2] = {16, 16};
  using V2 = float2;
};
template <>
struct Cfg<double> {
  static constexpr int kWarps = 16, kSlots = 1;
  static constexpr int kGOf[2] = {8, 4};
  using V2 = double2;
};

// A row's flavor: its leaves' partners x_{j+H} fall only in the chunk
// slots g with bitrev(g) < kSlots (n a power of two, which has none, or
// n <= 1.125 H or so: every width the port runs but 2 x 20^2), so they
// take few registers; or anywhere.
constexpr int kSparse = 0, kDense = 1;

template <typename T>
__host__ __device__ constexpr int threads_of() {
  return 32 * Cfg<T>::kWarps;
}

__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
// 1e-30 rounded to the type, as PyTorch adds a Python float to a tensor
__device__ __forceinline__ float tiny(float) { return 1e-30f; }
__device__ __forceinline__ double tiny(double) { return 1e-30; }

__host__ __device__ constexpr int log2_of_pow2(int g) {
  return g <= 1 ? 0 : 1 + log2_of_pow2(g / 2);
}

// bitrev of g over ``bits`` bits, at compile time.
__host__ __device__ constexpr unsigned brev_bits(unsigned g, int bits) {
  return bits == 0 ? 0u : ((g & 1u) << (bits - 1)) | brev_bits(g >> 1, bits - 1);
}

// bitrev of c over kBits bits.
template <int kBits>
__device__ __forceinline__ unsigned brev_low(unsigned c) {
  if constexpr (kBits == 0) {
    return 0u;
  } else {
    return __brev(c) >> (32 - kBits);
  }
}

// The largest power of two <= n, and at least lo (a power of two).
__host__ __device__ inline int fold_length(int n, int lo) {
  long long h = lo;
  while (2 * h <= n) h *= 2;
  return static_cast<int>(h);
}

// Where a pass reads v_j: (vr, vi) pairs in shared memory, or (kVInL2)
// v_j = w_j / nrm from the last pass's w in L2, (v0, 0) on pass 0.
template <typename T, int kMode>
struct VRead {
  const typename Cfg<T>::V2* v_s;
  const T* wr;
  const T* wi;
  T nrm, v0;
  bool first;

  __device__ __forceinline__ void at(int j, T& u, T& w) const {
    if constexpr (kMode == kVInL2) {
      if (first) {
        u = v0;
        w = T(0);
      } else {
        u = div_rn(__ldcg(wr + j), nrm);
        w = div_rn(__ldcg(wi + j), nrm);
      }
    } else {
      const typename Cfg<T>::V2 x = v_s[j];
      u = x.x;
      w = x.y;
    }
  }
};

// Where a warp reads a row: device memory; device memory, copying it into
// its shared-memory slab rows; the slab rows.
constexpr int kFromGlobal = 0, kToSlab = 1, kFromSlab = 2;

template <int kSrc, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kSrc == kFromSlab) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// One row's four products on a warp, each in the folded tree over the H =
// 32 2^LQ leaves: lane l holds j = l + 32 q, leaf x_j (zero past n) plus
// x_{j+H} where j + H < n, and walks q in bit-reversed order, G leaves a
// load.  Leaf g of chunk c is q = bitrev(c G + g) = bitrev(g) 2^lc +
// bitrev(c) (lc = LQ - log2 G), so a chunk's leaves are one offset and G
// compile-time steps.  The chunk's leaves are added as adjacent pairs and
// the chunks merged by a binary counter (the halving tree over q walked in
// that order), then the five lane levels by shuffles.  The row's sums end
// in lane 0's ``out``.  With kToSlab the row is also copied to (sa, sb).
template <typename T, int LQ, int kFlavor, int kMode, int kSrc>
__device__ __forceinline__ void row_sums(const T* __restrict__ a,
                                         const T* __restrict__ b, T* sa,
                                         T* sb, const VRead<T, kMode>& v,
                                         int n, int lane, T (&out)[4]) {
  constexpr int kQ = 1 << LQ;
  constexpr int kGMax = Cfg<T>::kGOf[kFlavor];
  constexpr int kG = kGMax < kQ ? kGMax : kQ;
  constexpr int kLogG = log2_of_pow2(kG);
  constexpr int kLC = LQ - kLogG;
  constexpr int kH = 32 * kQ;
  // the chunk slots that may hold a partner: slot bitrev(g) < kGP
  constexpr int kGP = kFlavor == kDense || Cfg<T>::kSlots > kG
                          ? kG
                          : Cfg<T>::kSlots;
  T cnt[4][kLC > 0 ? kLC : 1] = {};
  for (unsigned c = 0; c < (1u << kLC); ++c) {
    const int j0 = lane + 32 * static_cast<int>(brev_low<kLC>(c));
    T ra[kG], rb[kG], pa[kGP], pb[kGP];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int slot = static_cast<int>(brev_bits(g, kLogG));
      const int j = j0 + (slot << (kLC + 5));
      ra[g] = rb[g] = T(0);
      if (j < n) {
        ra[g] = load<kSrc>(a + j);
        rb[g] = load<kSrc>(b + j);
      }
      if (slot < kGP) {
        const int p = slot < kGP ? slot : 0;
        pa[p] = pb[p] = T(0);
        if (j + kH < n) {
          pa[p] = load<kSrc>(a + j + kH);
          pb[p] = load<kSrc>(b + j + kH);
        }
      }
    }
    if constexpr (kSrc == kToSlab) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int slot = static_cast<int>(brev_bits(g, kLogG));
        const int j = j0 + (slot << (kLC + 5));
        if (j < n) {
          sa[j] = ra[g];
          sb[j] = rb[g];
        }
        if (slot < kGP && j + kH < n) {
          sa[j + kH] = pa[slot < kGP ? slot : 0];
          sb[j + kH] = pb[slot < kGP ? slot : 0];
        }
      }
    }
    // each leaf's products go straight into the chunk's adjacent-pair
    // levels (a counter over its G leaves, closed at the last leaf)
    T pairs[4][kLogG > 0 ? kLogG : 1] = {};
    T s[4];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int slot = static_cast<int>(brev_bits(g, kLogG));
      const int j = j0 + (slot << (kLC + 5));
      T x[4] = {T(0), T(0), T(0), T(0)};
      if (j < n) {
        T u, w;
        v.at(j, u, w);
        x[0] = mul_rn(ra[g], u);
        x[1] = mul_rn(rb[g], w);
        x[2] = mul_rn(ra[g], w);
        x[3] = mul_rn(rb[g], u);
        if (slot < kGP && j + kH < n) {
          const int p = slot < kGP ? slot : 0;
          v.at(j + kH, u, w);
          x[0] = add_rn(x[0], mul_rn(pa[p], u));
          x[1] = add_rn(x[1], mul_rn(pb[p], w));
          x[2] = add_rn(x[2], mul_rn(pa[p], w));
          x[3] = add_rn(x[3], mul_rn(pb[p], u));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (kLogG == 0) {
          s[k] = x[k];
        } else {
          s[k] = counter_push<T, kLogG>(pairs[k], x[k], g);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kLC == 0) {
        out[k] = s[k];
      } else {
        out[k] = counter_push<T, kLC>(cnt[k], s[k], c);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int h = 16; h >= 1; h /= 2)
      out[k] = add_rn(out[k], __shfl_down_sync(0xffffffffu, out[k], h));
  }
}

// Stream a row's 16-byte-aligned interior from device memory into L2 in one
// bulk copy (its edges load as they are read).
template <typename T>
__device__ __forceinline__ void prefetch_l2(const T* p, int n) {
  const unsigned long long a = __cvta_generic_to_global(p);
  const unsigned long long lo = (a + 15) & ~15ull;
  const unsigned long long hi = (a + static_cast<unsigned long long>(n) * sizeof(T)) & ~15ull;
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :
                 : "l"(lo), "r"(static_cast<unsigned int>(hi - lo))
                 : "memory");
}

// A pass over CTA r's rows i = r + C k, k = warp + kWarps t (t backwards on
// odd passes): row i's (wr, wi) to (wout[i], wout[n + i]).  The slab holds
// the CTA's rows k of sr, then of si, R = ceil(n / C) each.
template <typename T, int LQ, int kFlavor, int kMode, int kSrc>
__device__ __forceinline__ void rows_pass(const T* A, const T* Bm, T* slab,
                                          int R, const VRead<T, kMode>& v,
                                          T* wout, int n, int r, int C,
                                          int rows, bool backwards,
                                          bool prefetch) {
  constexpr int kWarps = Cfg<T>::kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mine = rows > warp ? (rows - 1 - warp) / kWarps + 1 : 0;
  for (int t = 0; t < mine; ++t) {
    const int k = warp + kWarps * (backwards ? mine - 1 - t : t);
    const long long i = r + static_cast<long long>(C) * k;
    T* sa = slab + static_cast<long long>(k) * n;
    T* sb = slab + static_cast<long long>(R + k) * n;
    const T* a = kSrc == kFromSlab ? sa : A + i * n;
    const T* b = kSrc == kFromSlab ? sb : Bm + i * n;
    if (kSrc != kFromSlab && prefetch && lane == 0) {
      prefetch_l2(a, n);
      prefetch_l2(b, n);
    }
    T out[4];
    row_sums<T, LQ, kFlavor, kMode, kSrc>(a, b, sa, sb, v, n, lane, out);
    if (lane == 0) {
      __stcg(wout + i, sub_rn(out[0], out[1]));
      __stcg(wout + n + i, add_rn(out[2], out[3]));
    }
  }
}

// s = sum_i q(i) for q(i) >= +0 in the halving tree over i < n, every
// thread of the CTA taking part: the levels past Hn = fold_length(n, 64)
// add zeros and are skipped; level Hn (i + Hn < n) and Hn / 2 as the terms
// are read; the levels Hn / 4 ... 32 in shared memory (z_s, Hn / 2 values);
// the last five by shuffles in warp 0.  Every thread gets s.
template <typename T, typename Q>
__device__ __forceinline__ T chain_norm(const Q& q, int n, T* z_s, T* bcast) {
  const int hn = fold_length(n, 64), hh = hn / 2;
  auto y = [&](int i) {
    T x = i < n ? q(i) : T(0);
    if (i + hn < n) x = add_rn(x, q(i + hn));
    return x;
  };
  for (int i = threadIdx.x; i < hh; i += blockDim.x)
    z_s[i] = add_rn(y(i), y(i + hh));
  __syncthreads();
  for (int h = hh / 2; h >= 32; h /= 2) {
    for (int i = threadIdx.x; i < h; i += blockDim.x)
      z_s[i] = add_rn(z_s[i], z_s[i + h]);
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    T s = z_s[threadIdx.x];
#pragma unroll
    for (int h = 16; h >= 1; h /= 2)
      s = add_rn(s, __shfl_down_sync(0xffffffffu, s, h));
    if (threadIdx.x == 0) *bcast = s;
  }
  __syncthreads();
  return *bcast;
}

// The chain's C CTAs wait for each other, the writes before the barrier
// visible after it: the chain's arrival counter in device memory reaches
// C * phase.  Every CTA is resident (a cooperative launch), so the spin
// ends.
__device__ __forceinline__ void chain_sync(unsigned int* count, int C,
                                           int phase) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(count, 1u);
    const unsigned int target = static_cast<unsigned int>(C) * phase;
    unsigned int seen;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if (seen >= target) break;
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The bytes of shared memory a CTA needs: v as pairs (2 n values, unless
// v_in_l2), the norm's Hn / 2 values and one to broadcast it, and in the
// on-chip mode the CTA's R = ceil(n / C) rows of sr and of si.
template <typename T>
long long smem_need(int n, int ctas, int mode) {
  long long values = (mode == kVInL2 ? 0 : 2ll * n) + fold_length(n, 64) / 2 + 1;
  if (mode == kOnChip) values += 2ll * ((n + ctas - 1) / ctas) * n;
  return values * static_cast<long long>(sizeof(T));
}

// Chain b's power iteration on its gridDim.x CTAs.  Scratch: wbuf (2,
// batch, 2, n), the w of even and odd passes; bar (batch,), zeros, left
// zero.  Shared memory as smem_need lays it out.
template <typename T, int LQ, int kFlavor, int kMode>
__device__ __forceinline__ void chain_power(const T* __restrict__ sr,
                                            const T* __restrict__ si,
                                            T* __restrict__ sigma, T* wbuf,
                                            unsigned int* bar, int batch,
                                            long long b, int n, int iters,
                                            bool prefetch,
                                            unsigned char* smem) {
  using V2 = typename Cfg<T>::V2;
  constexpr int kThreads = threads_of<T>();
  const int C = static_cast<int>(gridDim.x);
  const int r = static_cast<int>(blockIdx.x);
  const int rows = r < n ? (n - r + C - 1) / C : 0;
  const int R = (n + C - 1) / C;
  V2* v_s = reinterpret_cast<V2*>(smem);
  T* z_s = reinterpret_cast<T*>(smem) + (kMode == kVInL2 ? 0 : 2 * n);
  T* bcast = z_s + fold_length(n, 64) / 2;
  T* slab = bcast + 1;
  unsigned int* count = bar + b;
  const long long nn = static_cast<long long>(n) * n;
  const T* A = sr + b * nn;
  const T* Bm = si + b * nn;
  auto w_of = [&](int p) {
    return wbuf + (static_cast<long long>(p & 1) * batch + b) * 2 * n;
  };
  auto q_l2 = [&](const T* w) {
    return [w, n](int i) {
      const T x = __ldcg(w + i), y = __ldcg(w + n + i);
      return add_rn(mul_rn(x, x), mul_rn(y, y));
    };
  };

  // v = (1/sqrt(n), 0), made by every CTA
  const T v0 = div_rn(T(1), sqrt_rn(static_cast<T>(n)));
  if constexpr (kMode != kVInL2) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      V2 x;
      x.x = v0;
      x.y = T(0);
      v_s[j] = x;
    }
    __syncthreads();
  }
  T nrm = T(1);
  for (int p = 0; p <= iters; ++p) {
    const T* wprev = w_of(p - 1);
    const VRead<T, kMode> v{v_s, wprev, wprev + n, nrm, v0, p == 0};
    T* wout = w_of(p);
    const bool back = (p & 1) != 0;
    if constexpr (kMode == kOnChip) {
      if (p == 0)
        rows_pass<T, LQ, kFlavor, kMode, kToSlab>(A, Bm, slab, R, v, wout, n,
                                                r, C, rows, back, prefetch);
      else
        rows_pass<T, LQ, kFlavor, kMode, kFromSlab>(A, Bm, slab, R, v, wout,
                                                  n, r, C, rows, back, false);
    } else {
      rows_pass<T, LQ, kFlavor, kMode, kFromGlobal>(A, Bm, slab, R, v, wout,
                                                  n, r, C, rows, back,
                                                  prefetch);
    }
    if (p < iters) {
      chain_sync(count, C, p + 1);
      T s;
      if constexpr (kMode == kVInL2) {
        s = chain_norm<T>(q_l2(wout), n, z_s, bcast);
      } else {
        for (int j = threadIdx.x; j < n; j += kThreads) {
          V2 x;
          x.x = __ldcg(wout + j);
          x.y = __ldcg(wout + n + j);
          v_s[j] = x;
        }
        __syncthreads();
        s = chain_norm<T>(
            [v_s](int i) {
              const V2 x = v_s[i];
              return add_rn(mul_rn(x.x, x.x), mul_rn(x.y, x.y));
            },
            n, z_s, bcast);
      }
      nrm = add_rn(sqrt_rn(s), tiny(s));
      if constexpr (kMode != kVInL2) {
        for (int j = threadIdx.x; j < n; j += kThreads) {
          V2 x = v_s[j];
          x.x = div_rn(x.x, nrm);
          x.y = div_rn(x.y, nrm);
          v_s[j] = x;
        }
        __syncthreads();
      }
    } else {
      // the last pass: the chain's last CTA to arrive adds the norm
      __threadfence();
      __syncthreads();
      int last = 0;
      if (threadIdx.x == 0) {
        last = atomicAdd(count, 1u) + 1 ==
               static_cast<unsigned int>(C) * (iters + 1);
        if (last) __threadfence();
      }
      if (__syncthreads_or(last)) {
        const T s = chain_norm<T>(q_l2(wout), n, z_s, bcast);
        if (threadIdx.x == 0) {
          sigma[b] = sqrt_rn(s);
          atomicExch(count, 0u);
        }
      }
    }
  }
}

// The chains blockIdx.y, blockIdx.y + gridDim.y, ... one after another:
// the launch holds gridDim.y chains at a time.
template <typename T, int LQ, int kFlavor, int kMode>
__global__ void __launch_bounds__(32 * Cfg<T>::kWarps, 1)
    sigma_cap_kernel(const T* __restrict__ sr, const T* __restrict__ si,
                     T* __restrict__ sigma, T* wbuf, unsigned int* bar,
                     int batch, int n, int iters, int prefetch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for (long long b = blockIdx.y; b < batch; b += gridDim.y)
    chain_power<T, LQ, kFlavor, kMode>(sr, si, sigma, wbuf, bar, batch, b, n,
                                     iters, prefetch != 0, smem_raw);
}

template <typename T>
using Kernel = void (*)(const T*, const T*, T*, T*, unsigned int*, int, int,
                        int, int);

// The mode's kernel for a lane's 2^lq leaves, LQ and below.
template <typename T, int kFlavor, int kMode, int LQ>
Kernel<T> pick(int lq) {
  if constexpr (LQ < 0) {
    return nullptr;
  } else {
    if (lq == LQ) return sigma_cap_kernel<T, LQ, kFlavor, kMode>;
    return pick<T, kFlavor, kMode, LQ - 1>(lq);
  }
}

// The kernel for n in ``mode``: the flavor of a row of n (H =
// fold_length(n, 32), Q = H / 32 leaves a lane, G of them a load): kSparse
// where every partner (q < Qp = ceil((n - H) / 32), none where n <= H)
// falls in a slot bitrev(g) < kSlots of its chunk, i.e. ceil(Qp / (Q / G))
// <= kSlots; else kDense.  The on-chip mode is built for kSparse,
// v_in_l2 for kDense (any n).
template <typename T>
int flavor_of(int n, int mode) {
  if (mode == kVInL2) return kDense;
  const int h = fold_length(n, 32), q = h / 32;
  const int g = Cfg<T>::kGOf[kSparse] < q ? Cfg<T>::kGOf[kSparse] : q;
  const int slots = Cfg<T>::kSlots < g ? Cfg<T>::kSlots : g;
  const int qp = n > h ? (n - h + 31) / 32 : 0, chunks = q / g;
  return (qp + chunks - 1) / chunks <= slots ? kSparse : kDense;
}

template <typename T>
Kernel<T> kernel_for(int n, int mode) {
  if (n < 1) return nullptr;
  const int h = fold_length(n, 32);
  int lq = 0;
  while ((32 << lq) < h) ++lq;
  switch (mode * 2 + flavor_of<T>(n, mode)) {
    case kStream * 2 + kSparse:
      return pick<T, kSparse, kStream, kMaxLQ>(lq);
    case kStream * 2 + kDense:
      return pick<T, kDense, kStream, kMaxLQ>(lq);
    case kOnChip * 2 + kSparse:
      return pick<T, kSparse, kOnChip, kMaxOnChipLQ>(lq);
    case kVInL2 * 2 + kDense:
      return pick<T, kDense, kVInL2, kMaxLQ>(lq);
  }
  return nullptr;
}

// Allow all of a block's shared memory, once a kernel.
template <typename T>
cudaError_t prepare(Kernel<T> kernel) {
  constexpr int kKernels = 64;
  static Kernel<T> done[kKernels] = {};
  static int count = 0;
  for (int i = 0; i < count; ++i)
    if (done[i] == kernel) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && count < kKernels) done[count++] = kernel;
  return e;
}

// CTAs of a call at n in ``mode`` with ``smem`` bytes of shared memory a
// CTA that one SM holds, and the card's SMs (0, 0: it cannot launch).
template <typename T>
cudaError_t occupancy(Kernel<T> kernel, int smem, int* per_sm, int* sms) {
  *per_sm = *sms = 0;
  if (kernel == nullptr || smem > kMaxSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = prepare<T>(kernel);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads_of<T>(), smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    *per_sm = *sms = 0;
  }
  return e;
}

template <typename T>
int resident(int n, int smem, int mode) {
  int per_sm = 0, sms = 0;
  occupancy<T>(kernel_for<T>(n, mode), smem, &per_sm, &sms);
  return per_sm * sms;
}

// The kernel's registers, local (spilled) bytes a thread, threads a CTA,
// CTAs an SM at ``smem``, the card's SMs and the row's flavor, into
// out[0..5].
template <typename T>
int attrs(int n, int smem, int mode, int* out) {
  const Kernel<T> kernel = kernel_for<T>(n, mode);
  if (kernel == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t e = prepare<T>(kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess) e = occupancy<T>(kernel, smem, &per_sm, &sms);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = threads_of<T>();
  out[3] = per_sm;
  out[4] = sms;
  out[5] = flavor_of<T>(n, mode);
  return 0;
}

// One cooperative launch of ctas x at_once CTAs.
template <typename T>
int launch(const T* sr, const T* si, T* sigma, T* wbuf, unsigned int* bar,
           int batch, int n, int ctas, int at_once, int iters, int smem,
           int mode, int prefetch, cudaStream_t stream) {
  const Kernel<T> kernel = kernel_for<T>(n, mode);
  if (kernel == nullptr || ctas < 1 || bar == nullptr || at_once < 1 ||
      at_once > batch || iters < 0 || smem > kMaxSmem ||
      smem < smem_need<T>(n, ctas, mode))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = prepare<T>(kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, at_once, 1);
  cfg.blockDim = dim3(threads_of<T>(), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, sr, si, sigma, wbuf, bar, batch, n,
                         iters, prefetch);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifndef SIGMA_CAP_F64
// How many CTAs of a call at n in ``mode`` with ``smem`` bytes of shared
// memory the card holds at once (0: it cannot launch).
extern "C" int dwh_sigma_cap_resident_f32(int n, int smem, int mode) {
  return resident<float>(n, smem, mode);
}

// The kernel's registers, spilled bytes a thread, threads a CTA, CTAs an
// SM at ``smem``, SMs and the row's flavor (0 partners in a few slots of a
// load, 1 anywhere), into out[0..5].  Returns a cudaError_t.
extern "C" int dwh_sigma_cap_attrs_f32(int n, int smem, int mode, int* out) {
  return attrs<float>(n, smem, mode, out);
}

// sr, si: (batch, n, n) row-major; sigma: (batch,); wbuf: (2, batch, 2, n)
// scratch; bar: (batch,) zeros, which the launch leaves zero.  ``at_once``
// chains run at a time, ``ctas`` CTAs each, in ``mode``; ``prefetch``
// streams each row into L2 as a warp starts it.  Returns the cudaError_t
// of the launch.
extern "C" int dwh_sigma_cap_f32(const float* sr, const float* si,
                                 float* sigma, float* wbuf, unsigned int* bar,
                                 int batch, int n, int ctas, int at_once,
                                 int iters, int smem, int mode, int prefetch,
                                 cudaStream_t stream) {
  return launch<float>(sr, si, sigma, wbuf, bar, batch, n, ctas, at_once,
                       iters, smem, mode, prefetch, stream);
}
#else
// The same entry points in float64 (sigma_cap_f64.cu).
extern "C" int dwh_sigma_cap_resident_f64(int n, int smem, int mode) {
  return resident<double>(n, smem, mode);
}

extern "C" int dwh_sigma_cap_attrs_f64(int n, int smem, int mode, int* out) {
  return attrs<double>(n, smem, mode, out);
}

extern "C" int dwh_sigma_cap_f64(const double* sr, const double* si,
                                 double* sigma, double* wbuf,
                                 unsigned int* bar, int batch, int n,
                                 int ctas, int at_once, int iters, int smem,
                                 int mode, int prefetch, cudaStream_t stream) {
  return launch<double>(sr, si, sigma, wbuf, bar, batch, n, ctas, at_once,
                        iters, smem, mode, prefetch, stream);
}
#endif
