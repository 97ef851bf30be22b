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

// Smallest P = 2^k >= max(m, 256); the values each thread holds,
// V = min(P / 256, 16); its threads P / V (at most 1024).
struct Tree {
  int threads, values;
};

inline Tree tree_for(int m) {
  int p = 256;
  while (p < m) p *= 2;
  const int v = p / 256 < 16 ? p / 256 : 16;
  return {p / v, v};
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

}  // namespace

// x: (rows, m) row-major; out: (rows,).  m <= 16384 (ops/kernels.py checks).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dwh_chain_sum_f32(const float* x, float* out, int rows, int m,
                                 cudaStream_t stream) {
  return dispatch<float, SumLaunch>(tree_for(m), x, out, rows, m, stream);
}

extern "C" int dwh_chain_sum_f64(const double* x, double* out, int rows,
                                 int m, cudaStream_t stream) {
  return dispatch<double, SumLaunch>(tree_for(m), x, out, rows, m, stream);
}

// ar, ai: (batch, n, n) row-major; vr, vi, wr, wi: (batch, n).  n <= 16384.
extern "C" int dwh_chain_matvec_f32(const float* ar, const float* ai,
                                    const float* vr, const float* vi,
                                    float* wr, float* wi, int batch, int n,
                                    cudaStream_t stream) {
  return dispatch<float, MatvecLaunch>(tree_for(n), ar, ai, vr, vi, wr, wi,
                                       batch, n, stream);
}

extern "C" int dwh_chain_matvec_f64(const double* ar, const double* ai,
                                    const double* vr, const double* vi,
                                    double* wr, double* wi, int batch, int n,
                                    cudaStream_t stream) {
  return dispatch<double, MatvecLaunch>(tree_for(n), ar, ai, vr, vi, wr, wi,
                                        batch, n, stream);
}
