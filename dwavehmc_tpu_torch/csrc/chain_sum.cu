// K3: per-chain sums whose order does not depend on the batch.
//
// Not a port of a TPU kernel.  The JAX package's per-chain reductions (the
// HMC energies' jnp.sum over the fields and the levels,
// dwavehmc_tpu/sampler/hmc_real.py) leave their order to XLA.  PyTorch's CUDA
// reduction chooses its launch, and so its order of addition, by the size of
// the batch: one chain gets other bits in a batch of 4 than in a batch of 8.
// This kernel adds every row in one fixed order, a halving tree:
//
//   pad the row with zeros to P = max(256, next power of two >= m);
//   for h = P/2, P/4, ..., 1:  x[i] = x[i] + x[i + h]  for i < h;
//   the sum is x[0].
//
// ops/kernels.py's plain version runs the same tree with tensor slices, so
// the kernel and its plain version agree to the bit.  Every add is rounded
// on its own (__fadd_rn), so nvcc cannot fuse them.
//
// K3 chain_sum:     x (rows, m) -> out (rows,).
//
// Design: one block per row, T = P / V threads, V = min(P / 256, 16) values
// of the tree per thread.  Thread t holds x[t + T*j], j < V, in registers,
// so the levels with h >= T are register adds within a thread; the levels
// T/2 ... 32 go through shared memory, and the last five are warp shuffles.
// It is bound by memory.
//
// Long rows (P > P0 = 16384) keep the tree.  A block of T = 512 threads
// (any power of two >= 32 gives the same tree) splits it at level T: thread
// t folds its Q = P / T elements y_q = x[t + T*q] while it loads them.  The
// levels h >= T of the halving tree are a halving tree over q, which pairs q
// with q + Q/2 first.  Walked in the bit-reversed order of q, that tree is the
// tree of adjacent pairs, which a running binary counter adds as it goes:
// the thread loads G leaves of the walk at a time, adds them as adjacent
// pairs, and merges each chunk's sum into a counter of depth D (register
// arrays with static indices).  The levels below T are block_levels, as for
// short rows.  The zero pads are added like any other value.
#include <cuda_runtime.h>

#include "halving_tree.cuh"

namespace {

using namespace halving_tree;

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

// The longest tree one block holds with registers alone (P0), and the long
// rows' geometry: T threads (the kernel's launch bounds), G leaves a load,
// counter depth D.  D bounds a row at T * G * 2^D = 2^37 values.
constexpr long long kSumTree = 16384;
constexpr int kSumThreads = 512, kSumLeaves = 16, kSumDepth = 24;

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
