// K3 and K4: per-chain sums whose order does not depend on the batch.
//
// Not a port of a TPU kernel.  The JAX package's per-chain reductions (the
// HMC energies' jnp.sum over the fields and the levels,
// dwavehmc_tpu/sampler/hmc_real.py; the sigma cap's power iteration,
// dwavehmc_tpu/ops/tracked_eigh.py) leave their order to XLA.  PyTorch's CUDA
// reduction and cuBLAS's batched matrix-vector product choose their launch,
// and so their order of addition, by the size of the batch: one chain gets
// other bits in a batch of 4 than in a batch of 8.  These kernels add every
// row in one fixed order, a halving tree:
//
//   pad the row with zeros to P = max(256, next power of two >= m);
//   for h = P/2, P/4, ..., 1:  x[i] = x[i] + x[i + h]  for i < h;
//   the sum is x[0].
//
// ops/kernels.py's plain versions run the same tree with tensor slices, so a
// kernel and its plain version agree to the bit.  Every add and product is
// rounded on its own (__fmul_rn, __fadd_rn), so nvcc cannot fuse them.
//
// K3 chain_sum:     x (rows, m) -> out (rows,).
// K4 chain_matvec:  (ar + i ai)(vr + i vi) for ar, ai (batch, n, n) and
//                   vr, vi (batch, n): wr = ar.vr - ai.vi, wi = ar.vi + ai.vr,
//                   each of the four dot products its own tree.
//
// Design: one block per row, T = P / V threads, V = min(P / 256, 16) values
// of each tree per thread.  Thread t holds x[t + T*j], j < V, in registers,
// so the levels with h >= T are register adds within a thread; the levels
// T/2 ... 32 go through shared memory, and the last five are warp shuffles.
// K4 reads each matrix row once (the four products share the loads), half
// the bytes of the four cuBLAS products it replaces.  Both are bound by
// memory: K4 reads 2 n^2 values a chain.
//
// Long rows (P > P0: 16384 for K3, 4096 for K4, whose four trees of 16
// values a thread fill a block's registers in float64) keep the tree.  A
// block of T threads (512 for K3, 256 for K4; any power of two >= 32 gives
// the same tree) splits it at level T: thread t folds its Q = P / T
// elements y_q = x[t + T*q] while it loads them.  The levels
// h >= T of the halving tree are a halving tree over q, which pairs q with
// q + Q/2 first.  Walked in the bit-reversed order of q, that tree is the
// tree of adjacent pairs, which a running binary counter adds as it goes:
// the thread loads G leaves of the walk at a time, adds them as adjacent
// pairs, and merges each chunk's sum into a counter of depth D (register
// arrays with static indices).  The levels below T are block_levels, as for
// short rows.  The zero pads are added like any other value.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// The tree's levels h >= T, in registers: x[j] += x[j + V/2], halving V.
template <typename T, int V>
__device__ __forceinline__ T register_levels(T (&x)[V]) {
#pragma unroll
  for (int w = V / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) x[j] = add_rn(x[j], x[j + w]);
  }
  return x[0];
}

// The levels h = T/2 ... 1 of K trees at once; thread t holds element t of
// each in v[k].  smem holds K * T values.  Returns the sums in thread 0.
template <typename T, int K>
__device__ __forceinline__ void block_levels(T (&v)[K], T* smem, int nthr) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) smem[k * nthr + t] = v[k];
  __syncthreads();
  for (int h = nthr / 2; h >= 32; h /= 2) {
    if (t < h) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        smem[k * nthr + t] = add_rn(smem[k * nthr + t], smem[k * nthr + t + h]);
    }
    __syncthreads();
  }
  if (t < 32) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T s = smem[k * nthr + t];
#pragma unroll
      for (int h = 16; h >= 1; h /= 2)
        s = add_rn(s, __shfl_down_sync(0xffffffffu, s, h));
      v[k] = s;
    }
  }
}

// The adjacent-pair tree over G values, ((x0 + x1) + (x2 + x3)) + ...
template <typename T, int G>
__device__ __forceinline__ T pair_levels(T (&x)[G]) {
#pragma unroll
  for (int w = 1; w < G; w *= 2) {
#pragma unroll
    for (int j = 0; j < G; j += 2 * w) x[j] = add_rn(x[j], x[j + w]);
  }
  return x[0];
}

// Merge the sum s of chunk c (chunks taken in order) into the binary counter
// st: st[l] holds the left subtree of level l while its right one is being
// added.  Returns the subtree that closed; after the last chunk (c with all
// of its log2(chunks) <= D bits set) that is the whole tree.
template <typename T, int D>
__device__ __forceinline__ T counter_push(T (&st)[D], T s,
                                          unsigned long long c) {
  bool open = true;
#pragma unroll
  for (int l = 0; l < D; ++l) {
    if (open) {
      if ((c >> l) & 1ull) {
        s = add_rn(st[l], s);
      } else {
        st[l] = s;
        open = false;
      }
    }
  }
  return s;
}

// Leaf u of the bit-reversed walk over Q = 2^lq leaves: q = bitrev(u).
__device__ __forceinline__ long long walk_leaf(unsigned long long u, int lq) {
  return static_cast<long long>(__brevll(u) >> (64 - lq));
}

template <typename T, int V>
__global__ void chain_sum_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int m) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nthr = blockDim.x;
  const T* row = x + static_cast<long long>(blockIdx.x) * m;
  T r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + nthr * j;
    r[j] = i < m ? row[i] : T(0);
  }
  T v[1] = {register_levels<T, V>(r)};
  block_levels<T, 1>(v, smem, nthr);
  if (threadIdx.x == 0) out[blockIdx.x] = v[0];
}

template <typename T, int V>
__global__ void chain_matvec_kernel(const T* __restrict__ ar,
                                    const T* __restrict__ ai,
                                    const T* __restrict__ vr,
                                    const T* __restrict__ vi,
                                    T* __restrict__ wr, T* __restrict__ wi,
                                    int n) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int nthr = blockDim.x;
  const long long b = blockIdx.y;
  const long long off = (b * n + blockIdx.x) * static_cast<long long>(n);
  const T* pr = ar + off;
  const T* pi = ai + off;
  const T* xr = vr + b * n;
  const T* xi = vi + b * n;
  T rr[V], ii[V], ri[V], ir[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = threadIdx.x + nthr * j;
    if (i < n) {
      const T a = pr[i], c = pi[i], u = xr[i], w = xi[i];
      rr[j] = mul_rn(a, u);
      ii[j] = mul_rn(c, w);
      ri[j] = mul_rn(a, w);
      ir[j] = mul_rn(c, u);
    } else {
      rr[j] = ii[j] = ri[j] = ir[j] = T(0);
    }
  }
  T v[4] = {register_levels<T, V>(rr), register_levels<T, V>(ii),
            register_levels<T, V>(ri), register_levels<T, V>(ir)};
  block_levels<T, 4>(v, smem, nthr);
  if (threadIdx.x == 0) {
    const long long o = b * n + blockIdx.x;
    wr[o] = sub_rn(v[0], v[1]);
    wi[o] = add_rn(v[2], v[3]);
  }
}

// The longest tree one block holds with registers alone (P0), and the long
// rows' geometry: T threads (the kernels' launch bounds), G leaves a load,
// counter depth D.  D bounds a row at T * G * 2^D values: 2^37 for K3, 2^19
// for K4 (whose (n, n) matrices would then take terabytes).
constexpr long long kSumTree = 16384;
constexpr int kSumThreads = 512, kSumLeaves = 16, kSumDepth = 24;
constexpr long long kMatvecTree = 4096;
constexpr int kMatvecThreads = 256, kMatvecLeaves = 8, kMatvecDepth = 8;

// K3 on a row longer than one block's tree: Q = 2^lq elements a thread.
template <typename T, int G, int D>
__global__ void __launch_bounds__(kSumThreads)
    chain_sum_long_kernel(const T* __restrict__ x, T* __restrict__ out,
                          long long m, int lq) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long nthr = blockDim.x;
  const T* row = x + static_cast<long long>(blockIdx.x) * m;
  const unsigned long long chunks = (1ull << lq) / G;
  T st[D];
#pragma unroll
  for (int l = 0; l < D; ++l) st[l] = T(0);
  T s = T(0);
  for (unsigned long long c = 0; c < chunks; ++c) {
    T y[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long i = threadIdx.x + nthr * walk_leaf(c * G + g, lq);
      y[g] = i < m ? row[i] : T(0);
    }
    s = counter_push<T, D>(st, pair_levels<T, G>(y), c);
  }
  T v[1] = {s};
  block_levels<T, 1>(v, smem, static_cast<int>(nthr));
  if (threadIdx.x == 0) out[blockIdx.x] = v[0];
}

// K4 on rows longer than one block's tree: the four trees fold as K3's.
template <typename T, int G, int D>
__global__ void __launch_bounds__(kMatvecThreads)
    chain_matvec_long_kernel(const T* __restrict__ ar,
                             const T* __restrict__ ai,
                             const T* __restrict__ vr,
                             const T* __restrict__ vi, T* __restrict__ wr,
                             T* __restrict__ wi, int n, int lq) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long nthr = blockDim.x;
  const long long b = blockIdx.y;
  const long long off = (b * n + blockIdx.x) * static_cast<long long>(n);
  const T* pr = ar + off;
  const T* pi = ai + off;
  const T* xr = vr + b * n;
  const T* xi = vi + b * n;
  const unsigned long long chunks = (1ull << lq) / G;
  T s_rr[D], s_ii[D], s_ri[D], s_ir[D];
#pragma unroll
  for (int l = 0; l < D; ++l) s_rr[l] = s_ii[l] = s_ri[l] = s_ir[l] = T(0);
  T v[4] = {T(0), T(0), T(0), T(0)};
  for (unsigned long long c = 0; c < chunks; ++c) {
    T rr[G], ii[G], ri[G], ir[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long i = threadIdx.x + nthr * walk_leaf(c * G + g, lq);
      if (i < n) {
        const T a = pr[i], e = pi[i], u = xr[i], w = xi[i];
        rr[g] = mul_rn(a, u);
        ii[g] = mul_rn(e, w);
        ri[g] = mul_rn(a, w);
        ir[g] = mul_rn(e, u);
      } else {
        rr[g] = ii[g] = ri[g] = ir[g] = T(0);
      }
    }
    v[0] = counter_push<T, D>(s_rr, pair_levels<T, G>(rr), c);
    v[1] = counter_push<T, D>(s_ii, pair_levels<T, G>(ii), c);
    v[2] = counter_push<T, D>(s_ri, pair_levels<T, G>(ri), c);
    v[3] = counter_push<T, D>(s_ir, pair_levels<T, G>(ir), c);
  }
  block_levels<T, 4>(v, smem, static_cast<int>(nthr));
  if (threadIdx.x == 0) {
    const long long o = b * n + blockIdx.x;
    wr[o] = sub_rn(v[0], v[1]);
    wi[o] = add_rn(v[2], v[3]);
  }
}

// Smallest P = 2^k >= max(m, 256).
inline long long tree_length(long long m) {
  long long p = 256;
  while (p < m) p *= 2;
  return p;
}

inline int log2_of(long long p) {
  int k = 0;
  while ((1ll << k) < p) ++k;
  return k;
}

// A short row's geometry: the values each thread holds, V = min(P / 256,
// 16); its threads P / V (at most 1024).
struct Tree {
  int threads, values;
};

inline Tree tree_for(long long p) {
  const int v = p / 256 < 16 ? static_cast<int>(p / 256) : 16;
  return {static_cast<int>(p / v), v};
}

template <typename T, template <typename, int> class Launch, typename... A>
int dispatch(const Tree& t, A... args) {
  switch (t.values) {
    case 1: return Launch<T, 1>::run(t.threads, args...);
    case 2: return Launch<T, 2>::run(t.threads, args...);
    case 4: return Launch<T, 4>::run(t.threads, args...);
    case 8: return Launch<T, 8>::run(t.threads, args...);
    case 16: return Launch<T, 16>::run(t.threads, args...);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int V>
struct SumLaunch {
  static int run(int threads, const T* x, T* out, int rows, int m,
                 cudaStream_t stream) {
    const size_t smem = sizeof(T) * threads;
    chain_sum_kernel<T, V><<<rows, threads, smem, stream>>>(x, out, m);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int V>
struct MatvecLaunch {
  static int run(int threads, const T* ar, const T* ai, const T* vr,
                 const T* vi, T* wr, T* wi, int batch, int n,
                 cudaStream_t stream) {
    const size_t smem = 4 * sizeof(T) * threads;
    const dim3 grid(n, batch);
    chain_matvec_kernel<T, V><<<grid, threads, smem, stream>>>(
        ar, ai, vr, vi, wr, wi, n);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
int chain_sum_launch(const T* x, T* out, int rows, long long m,
                     cudaStream_t stream) {
  const long long p = tree_length(m);
  if (p <= kSumTree)
    return dispatch<T, SumLaunch>(tree_for(p), x, out, rows,
                                  static_cast<int>(m), stream);
  const int lq = log2_of(p / kSumThreads);
  if (lq - log2_of(kSumLeaves) > kSumDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  chain_sum_long_kernel<T, kSumLeaves, kSumDepth>
      <<<rows, kSumThreads, sizeof(T) * kSumThreads, stream>>>(x, out, m,
                                                               lq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int chain_matvec_launch(const T* ar, const T* ai, const T* vr, const T* vi,
                        T* wr, T* wi, int batch, int n,
                        cudaStream_t stream) {
  const long long p = tree_length(n);
  if (p <= kMatvecTree)
    return dispatch<T, MatvecLaunch>(tree_for(p), ar, ai, vr, vi, wr, wi,
                                     batch, n, stream);
  const int lq = log2_of(p / kMatvecThreads);
  if (lq - log2_of(kMatvecLeaves) > kMatvecDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n, batch);
  chain_matvec_long_kernel<T, kMatvecLeaves, kMatvecDepth>
      <<<grid, kMatvecThreads, 4 * sizeof(T) * kMatvecThreads, stream>>>(
          ar, ai, vr, vi, wr, wi, n, lq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, m) row-major; out: (rows,).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dwh_chain_sum_f32(const float* x, float* out, int rows,
                                 long long m, cudaStream_t stream) {
  return chain_sum_launch<float>(x, out, rows, m, stream);
}

extern "C" int dwh_chain_sum_f64(const double* x, double* out, int rows,
                                 long long m, cudaStream_t stream) {
  return chain_sum_launch<double>(x, out, rows, m, stream);
}

// ar, ai: (batch, n, n) row-major; vr, vi, wr, wi: (batch, n).
extern "C" int dwh_chain_matvec_f32(const float* ar, const float* ai,
                                    const float* vr, const float* vi,
                                    float* wr, float* wi, int batch, int n,
                                    cudaStream_t stream) {
  return chain_matvec_launch<float>(ar, ai, vr, vi, wr, wi, batch, n,
                                    stream);
}

extern "C" int dwh_chain_matvec_f64(const double* ar, const double* ai,
                                    const double* vr, const double* vi,
                                    double* wr, double* wi, int batch, int n,
                                    cudaStream_t stream) {
  return chain_matvec_launch<double>(ar, ai, vr, vi, wr, wi, batch, n,
                                     stream);
}
