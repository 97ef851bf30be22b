// K5 sigma_cap: the sigma cap's power iteration, one launch per call.
//
// Replaces the sigma cap of a tracked rotation, dwavehmc_tpu/ops/
// tracked_eigh.py::_spectral_norm_est (XLA's matmul and jnp.sum; no Pallas),
// which the port ran as four K4 launches, four K3 launches and elementwise
// launches, 37 device operations in all, one of them a blocking copy of a
// host scalar into the start vector.  For
// every chain b of S = sr + i si (batch, n, n), with iters = 3:
//
//   v = (1/sqrt(n), 0);
//   iters times:  w = S v;  nrm = sqrt(sum_i |w_i|^2) + 1e-30;  v = w / nrm;
//   w = S v;  sigma = sqrt(sum_i |w_i|^2).
//
// Bits.  The result equals ops/kernels.py::spectral_norm_est_plain bit for
// bit: 1/sqrt(n) as a correctly rounded square root and an IEEE division;
// each of the four dot products a row makes (sr.vr, si.vi, sr.vi, si.vr) in
// K4's halving tree over j, then w = (rr - ii, ri + ir); the norm in K3's
// tree over i of wr*wr + wi*wi, P = tree_length(n); sqrt, + 1e-30 rounded to
// the type, IEEE divisions; every operation rounded on its own
// (halving_tree.cuh).  A chain's bits do not depend on the batch.
//
// Bound: bytes.  Each pass streams all of S, 2 n^2 values a chain, and the
// passes depend on each other through the norm; four passes from device
// memory at 3.35 TB/s, or one when S stays in the 50 MB L2 (8 chains of
// n = 512 in float32: 16.8 MB).
//
// Design: one cooperative launch (every CTA resident) of C CTAs per chain,
// 8 warps each, C = 4 to 128 (the plan in ops/kernels.py: the most CTAs a
// chain with which the whole batch fits on the card at once, else 16 a
// chain and the chains in turns).  A chain's CTAs meet at a barrier on a
// counter in device memory.  Thread-block clusters of up to 16 CTAs with
// the hardware cluster barrier were measured too: slower at every
// shape than a cooperative launch of as many CTAs, and unable to give one
// or two chains more than 16.
// - Rows are dealt to CTAs by their low index bits, i = r + C k for CTA r,
//   so the norm's tree over i is CTA-local until its last log2(C) levels:
//   the levels over k in shared memory, then one partial per CTA, whose
//   halving tree every CTA of the chain adds itself.
// - One warp per row: lane l holds j = l + 32 q; each lane folds its leaves
//   in the bit-reversed order of q, G a chunk (16 float, or 8 where a lane
//   has 8; 4 double), with a binary counter of depth D, and the last five
//   levels are shuffles.  The row's copies are 32 consecutive values a warp
//   instruction.  A warp streams the chunks of all its rows as one sequence
//   through a ring of kStages chunks in shared memory (cp.async), so two
//   chunks are in flight while one is added.
// - v lives in each CTA's shared memory (2 n values, 135 KB at n = 8464 in
//   double) when the plan fits it there, else it is read from L2.  Between
//   passes the CTAs exchange v and the norm's partials through a global
//   scratch the wrapper allocates (written and read at L2, __stcg/__ldcg)
//   around a barrier of the chain's CTAs, two a pass.  No host sync and no
//   host-side scalar.
// - Odd passes walk their rows backwards, so a pass starts on the rows the
//   last one left in L2.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "halving_tree.cuh"

namespace {

using namespace halving_tree;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the most dynamic shared memory a block may use on Hopper
constexpr int kMaxSmem = 232448;

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

// Chunks in a warp's copy ring: kStages - 1 in flight while one is added.
constexpr int kStages = 3;

// bitrev of g over ``bits`` bits, at compile time.
__host__ __device__ constexpr unsigned brev_bits(unsigned g, int bits) {
  return bits == 0 ? 0u : ((g & 1u) << (bits - 1)) | brev_bits(g >> 1, bits - 1);
}

// v as (vr, vi) pairs: one load a leaf.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// A warp's rows i = r + C k, k = warp + kWarps t (t backwards on odd
// passes), each row's four products in the tree over its P = 32 2^lq
// leaves: lane l holds j = l + 32 q and walks q in bit-reversed order, G
// leaves a chunk.  Leaf g of chunk c is q = bitrev(c G + g) = bitrev(c) +
// bitrev(g) 2^lc (lc = lq - log2 G), so a chunk's leaves are one offset
// and G compile-time steps.  The chunks of all the warp's rows are one
// stream through a ring of kStages chunks in shared memory (``ring``:
// kStages x 2 x G x 32 values, cp.async), kStages - 1 in flight while one
// is added, each lane copying and reading only its own slots.  A leaf past
// n is not copied and adds a zero, as in the plain version.  The tree's
// levels: over q (pairs, then the counter), then over the lanes
// (shuffles).  Lane 0 writes each row's (wr, wi) and |w|^2 to slot k.
// v: (vr, vi) pairs in shared memory, or vr, vi in L2 (kSmemV false).
template <typename T, int G, int D, bool kSmemV>
__device__ __forceinline__ void warp_rows(const T* __restrict__ A,
                                          const T* __restrict__ Bi,
                                          const T* v2, const T* vr,
                                          const T* vi, int n, int lq, int r,
                                          int C, int warp, int lane, int mine,
                                          bool backwards, T* ring, T* w_s,
                                          T* q_s, int M) {
  constexpr int kLogG = log2_of_pow2(G);
  const int lc = lq - kLogG;
  const unsigned last = (1u << lc) - 1;
  const long long steps = static_cast<long long>(mine) << lc;
  // leaf g of chunk c is j = first(c) + (bitrev(g) << shift)
  const int shift = lc + 5;
  auto first = [&](unsigned c) {
    return lane + 32 * static_cast<int>(lc ? __brev(c) >> (32 - lc) : 0u);
  };
  auto slot = [&](long long step) {
    const int t = static_cast<int>(step >> lc);
    return warp + kWarps * (backwards ? mine - 1 - t : t);
  };
  auto fetch = [&](long long step) {
    if (step < steps) {
      const long long off = (r + static_cast<long long>(C) * slot(step)) * n;
      const T* pa = A + off;
      const T* pb = Bi + off;
      T* st = ring + (step % kStages) * 2 * G * 32 + lane;
      const int j0 = first(static_cast<unsigned>(step) & last);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + static_cast<int>(brev_bits(g, kLogG) << shift);
        if (j < n) {
          __pipeline_memcpy_async(st + g * 32, pa + j, sizeof(T));
          __pipeline_memcpy_async(st + (G + g) * 32, pb + j, sizeof(T));
        }
      }
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  T s_rr[D], s_ii[D], s_ri[D], s_ir[D];
  T v[4];
  for (long long step = 0; step < steps; ++step) {
    fetch(step + kStages - 1);
    __pipeline_wait_prior(kStages - 1);
    const T* st = ring + (step % kStages) * 2 * G * 32 + lane;
    const unsigned c = static_cast<unsigned>(step) & last;
    if (c == 0) {
#pragma unroll
      for (int l = 0; l < D; ++l) s_rr[l] = s_ii[l] = s_ri[l] = s_ir[l] = T(0);
    }
    const int j0 = first(c);
    T rr[G], ii[G], ri[G], ir[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = j0 + static_cast<int>(brev_bits(g, kLogG) << shift);
      T a = T(0), b = T(0), u = T(0), w = T(0);
      if (j < n) {
        a = st[g * 32];
        b = st[(G + g) * 32];
        if constexpr (kSmemV) {
          const typename Pair<T>::type x =
              reinterpret_cast<const typename Pair<T>::type*>(v2)[j];
          u = x.x;
          w = x.y;
        } else {
          u = __ldcg(vr + j);
          w = __ldcg(vi + j);
        }
      }
      rr[g] = mul_rn(a, u);
      ii[g] = mul_rn(b, w);
      ri[g] = mul_rn(a, w);
      ir[g] = mul_rn(b, u);
    }
    v[0] = counter_push<T, D>(s_rr, pair_levels<T, G>(rr), c);
    v[1] = counter_push<T, D>(s_ii, pair_levels<T, G>(ii), c);
    v[2] = counter_push<T, D>(s_ri, pair_levels<T, G>(ri), c);
    v[3] = counter_push<T, D>(s_ir, pair_levels<T, G>(ir), c);
    if (c == last) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int h = 16; h >= 1; h /= 2)
          v[k] = add_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], h));
      }
      if (lane == 0) {
        const int k = slot(step);
        const T wr = sub_rn(v[0], v[1]), wi = add_rn(v[2], v[3]);
        w_s[k] = wr;
        w_s[M + k] = wi;
        q_s[k] = add_rn(mul_rn(wr, wr), mul_rn(wi, wi));
      }
    }
  }
  __pipeline_wait_prior(0);
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

// Chain b's power iteration on its gridDim.x CTAs.  Scratch: vbuf (batch,
// 2, n), part (batch, C), bar (2 batch: zeros, left zero).  Shared memory:
// each warp's copy ring (kStages x 2 x G x 32), v as (vr, vi) pairs (2 n,
// if kSmemV), then wr, wi and the norm's terms of the CTA's rows (3 M, M =
// ceil(n / C)), the C partials, and one value to broadcast the norm.
template <typename T, int G, int D, bool kSmemV>
__device__ __forceinline__ void chain_power(
    const T* __restrict__ sr, const T* __restrict__ si, T* __restrict__ sigma,
    T* vbuf, T* part, unsigned int* bar, int batch, long long b, int n,
    int lq, int iters, T* sm) {
  const int C = static_cast<int>(gridDim.x);
  const int r = static_cast<int>(blockIdx.x);
  const int M = (n + C - 1) / C;
  const int rows = r < n ? (n - r + C - 1) / C : 0;
  T* ring = sm + (threadIdx.x / 32) * kStages * 2 * G * 32;
  T* v_s = sm + kWarps * kStages * 2 * G * 32;
  T* w_s = v_s + (kSmemV ? 2 * n : 0);
  T* q_s = w_s + 2 * M;
  T* p_s = q_s + M;
  T* bcast = p_s + C;
  unsigned int* count = bar + b;
  int phase = 0;
  T* vr_g = vbuf + b * 2 * n;
  T* vi_g = vr_g + n;
  T* part_g = part + b * C;
  const long long nn = static_cast<long long>(n) * n;
  const T* A = sr + b * nn;
  const T* Bi = si + b * nn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // v = (1/sqrt(n), 0) on this CTA's rows
  const T v0 = div_rn(T(1), sqrt_rn(static_cast<T>(n)));
  for (int k = threadIdx.x; k < rows; k += kThreads) {
    const long long i = r + static_cast<long long>(C) * k;
    __stcg(vr_g + i, v0);
    __stcg(vi_g + i, T(0));
  }
  chain_sync(count, C, ++phase);

  for (int p = 0; p <= iters; ++p) {
    if (kSmemV) {
      for (int j = threadIdx.x; j < n; j += kThreads) {
        v_s[2 * j] = __ldcg(vr_g + j);
        v_s[2 * j + 1] = __ldcg(vi_g + j);
      }
      __syncthreads();
    }
    const int mine = rows > warp ? (rows - 1 - warp) / kWarps + 1 : 0;
    warp_rows<T, G, D, kSmemV>(A, Bi, v_s, vr_g, vi_g, n, lq, r, C, warp,
                               lane, mine, (p & 1) != 0, ring, w_s, q_s, M);
    __syncthreads();
    // the norm's levels over k: a halving tree of 2^lk slots whose slots
    // past the CTA's rows hold zeros (x + 0 = x, so they are skipped)
    int live = rows;
    int h = 1;
    while (h < M) h *= 2;
    for (h /= 2; h >= 1; h /= 2) {
      for (int k = threadIdx.x; k < h && k + h < live; k += kThreads)
        q_s[k] = add_rn(q_s[k], q_s[k + h]);
      live = live < h ? live : h;
      __syncthreads();
    }
    if (threadIdx.x == 0) __stcg(part_g + r, rows > 0 ? q_s[0] : T(0));
    chain_sync(count, C, ++phase);
    // the last log2(C) levels, over the CTAs' partials
    for (int c = threadIdx.x; c < C; c += kThreads) p_s[c] = __ldcg(part_g + c);
    __syncthreads();
    for (int hh = C / 2; hh >= 1; hh /= 2) {
      for (int c = threadIdx.x; c < hh; c += kThreads)
        p_s[c] = add_rn(p_s[c], p_s[c + hh]);
      __syncthreads();
    }
    const T s = p_s[0];
    if (p == iters) {
      if (r == 0 && threadIdx.x == 0) sigma[b] = sqrt_rn(s);
      // the last CTA to leave zeroes the chain's counters for the next
      // call: every CTA has passed the last barrier when it counts out
      if (threadIdx.x == 0 && atomicAdd(count + batch, 1u) + 1 == C) {
        atomicExch(count, 0u);
        atomicExch(count + batch, 0u);
      }
      return;
    }
    const T nrm = add_rn(sqrt_rn(s), tiny(s));
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      const long long i = r + static_cast<long long>(C) * k;
      __stcg(vr_g + i, div_rn(w_s[k], nrm));
      __stcg(vi_g + i, div_rn(w_s[M + k], nrm));
    }
    chain_sync(count, C, ++phase);
  }
}

// The chains blockIdx.y, blockIdx.y + gridDim.y, ... one after another:
// the launch holds gridDim.y chains at a time.
template <typename T, int G, int D, bool kSmemV>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
    sigma_cap_kernel(const T* __restrict__ sr, const T* __restrict__ si,
                     T* __restrict__ sigma, T* vbuf, T* part,
                     unsigned int* bar, int batch, int n, int lq, int iters) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  for (long long b = blockIdx.y; b < batch; b += gridDim.y)
    chain_power<T, G, D, kSmemV>(sr, si, sigma, vbuf, part, bar, batch, b,
                                 n, lq, iters, sm);
}

inline int log2_of(long long p) {
  int k = 0;
  while ((1ll << k) < p) ++k;
  return k;
}

template <typename T>
using Kernel = void (*)(const T*, const T*, T*, T*, T*, unsigned int*, int,
                        int, int, int);

// The kernel for the 2^lq leaves of q a lane: counter depth D >= log2 of
// the chunks a lane folds.
template <typename T, int G, bool V>
Kernel<T> pick(int lq) {
  const int need = lq - log2_of(G);
  if (need <= 4) return sigma_cap_kernel<T, G, 4, V>;
  if (need <= 8) return sigma_cap_kernel<T, G, 8, V>;
  if (need <= 12) return sigma_cap_kernel<T, G, 12, V>;
  return nullptr;
}

// The kernel for n, and the log2 of a lane's leaves, P / 32.  Leaves a
// chunk (G): 16 float (8 where a row's tree has 256 leaves, 8 a lane) or 4
// double, as ops/kernels.py::sigma_cap_leaves says.
template <typename T>
struct Choice {
  Kernel<T> kernel;
  int lq;
};

template <typename T>
Choice<T> kernel_for(int n, bool v_in_smem) {
  long long p = 256;
  while (p < n) p *= 2;
  const int lq = log2_of(p / 32);
  if (sizeof(T) == 8)
    return {v_in_smem ? pick<T, 4, true>(lq) : pick<T, 4, false>(lq), lq};
  if (lq < 4)
    return {v_in_smem ? pick<T, 8, true>(lq) : pick<T, 8, false>(lq), lq};
  return {v_in_smem ? pick<T, 16, true>(lq) : pick<T, 16, false>(lq), lq};
}

// Allow all of a block's shared memory, once a kernel.
template <typename T>
cudaError_t prepare(Kernel<T> kernel) {
  static Kernel<T> done[12] = {};
  static int count = 0;
  for (int i = 0; i < count; ++i)
    if (done[i] == kernel) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && count < 12) done[count++] = kernel;
  return e;
}

// How many CTAs of a call at n with ``smem`` bytes of shared memory the
// card holds at once (0: it cannot launch).
template <typename T>
int resident(int n, int smem, int v_in_smem) {
  const Kernel<T> kernel = kernel_for<T>(n, v_in_smem != 0).kernel;
  if (kernel == nullptr || smem > kMaxSmem) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (prepare<T>(kernel) != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return per_sm * sms;
}

// One cooperative launch of ctas x at_once CTAs.
template <typename T>
int launch(const T* sr, const T* si, T* sigma, T* vbuf, T* part,
           unsigned int* bar, int batch, int n, int ctas, int at_once,
           int iters, int smem, int v_in_smem, cudaStream_t stream) {
  const Choice<T> choice = kernel_for<T>(n, v_in_smem != 0);
  if (choice.kernel == nullptr || ctas < 1 || (ctas & (ctas - 1)) ||
      bar == nullptr || at_once < 1 || at_once > batch)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = prepare<T>(choice.kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, at_once, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, choice.kernel, sr, si, sigma, vbuf, part, bar,
                         batch, n, choice.lq, iters);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many CTAs of a call at n with ``smem`` bytes of shared memory (v in
// it or not) the card holds at once (0: it cannot launch).
extern "C" int dwh_sigma_cap_resident_f32(int n, int smem, int v_in_smem) {
  return resident<float>(n, smem, v_in_smem);
}

extern "C" int dwh_sigma_cap_resident_f64(int n, int smem, int v_in_smem) {
  return resident<double>(n, smem, v_in_smem);
}

// sr, si: (batch, n, n) row-major; sigma: (batch,); vbuf: (batch, 2, n)
// and part: (batch, ctas) scratch; bar: (2 batch,) zeros, which the launch
// leaves zero.  ``at_once`` chains run at a time, ``ctas`` CTAs each.
// Returns the cudaError_t of the launch.
extern "C" int dwh_sigma_cap_f32(const float* sr, const float* si,
                                 float* sigma, float* vbuf, float* part,
                                 unsigned int* bar, int batch, int n,
                                 int ctas, int at_once, int iters, int smem,
                                 int v_in_smem, cudaStream_t stream) {
  return launch<float>(sr, si, sigma, vbuf, part, bar, batch, n, ctas,
                       at_once, iters, smem, v_in_smem, stream);
}

extern "C" int dwh_sigma_cap_f64(const double* sr, const double* si,
                                 double* sigma, double* vbuf, double* part,
                                 unsigned int* bar, int batch, int n,
                                 int ctas, int at_once, int iters, int smem,
                                 int v_in_smem, cudaStream_t stream) {
  return launch<double>(sr, si, sigma, vbuf, part, bar, batch, n, ctas,
                        at_once, iters, smem, v_in_smem, stream);
}
