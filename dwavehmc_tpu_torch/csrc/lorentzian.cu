// K2: weighted Lorentzian sum of the optical and DC conductivity.
//
// Replaces dwavehmc_tpu/ops/pallas_kernels.py::weighted_lorentzian_sum (its
// body _lorentz_kernel).  For every chain b and frequency k:
//
//   S[b, k] = sum_i w2[b, i] * (eta/pi) / ((omega[b, k] - de[b, i])^2 + eta^2)
//
// without ever holding the (n_omega x M) Lorentzian block in memory.
//
// Bound: operations.  At 24x24 one chain has M = 1,327,104 pairs and
// n_omega = 1436 frequencies, about 1.9e9 Lorentzians: a subtraction, a fused
// multiply-add, a reciprocal and a multiply-accumulate each, against only
// 8 M + 8 n_omega bytes of input.  The reciprocal goes through the special
// function unit, which has a quarter of the FMA rate.
//
// Design.  The TPU kernel carries each frequency's sum along a sequential
// grid axis; Hopper runs blocks in no order, so the pair axis is split
// across blocks instead.  Pass 1: a block stages one chunk of kChunk (de, w2)
// pairs in shared memory; its 256 threads are laid out as tw frequency lanes
// times 256/tw pair lanes; each thread keeps R frequencies in registers and
// walks its share of the chunk; the pair lanes are then summed by a fixed
// tree in shared memory, and the block writes one partial per frequency.
// Pass 2 sums each frequency's partials over the chunks in chunk order.
// There are no float atomics, so a run repeats bit for bit.  Splitting the
// pair axis matters most for the DC call, which has one frequency: there
// tw = 1 and all 256 threads of a block share the chunk's pairs.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;   // pairs per block: 32 KB of shared memory

template <int R>
__global__ void lorentz_partial_kernel(const float* __restrict__ omega,
                                       const float* __restrict__ de,
                                       const float* __restrict__ w2,
                                       float* __restrict__ partial,
                                       int n_w, int M, int n_chunks, int tw,
                                       float eta2) {
  __shared__ float s_de[kChunk];
  __shared__ float s_w2[kChunk];
  __shared__ float s_red[R * kThreads];

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const long long b = blockIdx.z;
  const int p0 = chunk * kChunk;
  const float* de_b = de + b * M;
  const float* w2_b = w2 + b * M;
  for (int p = tid; p < kChunk; p += kThreads) {
    const int gp = p0 + p;
    const bool in = gp < M;
    s_de[p] = in ? de_b[gp] : 0.0f;
    s_w2[p] = in ? w2_b[gp] : 0.0f;
  }
  __syncthreads();

  const int lane = tid % tw;     // frequency lane
  const int q = tid / tw;        // pair lane
  const int tp = kThreads / tw;
  const int w_base = blockIdx.y * tw * R;
  float om[R];
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = w_base + r * tw + lane;
    om[r] = w < n_w ? omega[b * n_w + w] : 0.0f;
    acc[r] = 0.0f;
  }
  const int n_p = min(kChunk, M - p0);
  for (int p = q; p < n_p; p += tp) {
    const float x0 = s_de[p];
    const float wt = s_w2[p];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float x = om[r] - x0;
      acc[r] += wt * __frcp_rn(x * x + eta2);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) s_red[r * kThreads + tid] = acc[r];
  __syncthreads();
  for (int s = tp / 2; s > 0; s >>= 1) {
    if (q < s) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        s_red[r * kThreads + tid] += s_red[r * kThreads + tid + s * tw];
    }
    __syncthreads();
  }
  if (q == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int w = w_base + r * tw + lane;
      if (w < n_w)
        partial[(b * n_chunks + chunk) * n_w + w] = s_red[r * kThreads + lane];
    }
  }
}

__global__ void lorentz_finalize_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int n_w,
                                        int n_chunks, float scale) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  if (w >= n_w) return;
  const float* p = partial + b * n_chunks * n_w + w;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += p[static_cast<long long>(c) * n_w];
  out[b * n_w + w] = scale * s;
}

}  // namespace

// Pairs per pass-1 block; the caller sizes `partial` as
// (batch, max(1, ceil(M / chunk)), n_w).
extern "C" int dwh_lorentzian_chunk_size() { return kChunk; }

// omega, out: (batch, n_w); de, w2: (batch, M); partial: scratch as above.
// Returns the first nonzero cudaError_t of the two launches (0 on success).
extern "C" int dwh_weighted_lorentzian_sum(const float* omega, const float* de,
                                           const float* w2, float* partial,
                                           float* out, int batch, int n_w,
                                           int M, int n_chunks, float eta,
                                           cudaStream_t stream) {
  int R = 1;
  int tw = 1;
  if (n_w >= 4 * kThreads) {
    R = 4;
    tw = kThreads;
  } else {
    while (tw < n_w && tw < kThreads) tw <<= 1;
  }
  const dim3 grid(n_chunks, (n_w + tw * R - 1) / (tw * R), batch);
  const float eta2 = eta * eta;
  if (R == 4) {
    lorentz_partial_kernel<4><<<grid, kThreads, 0, stream>>>(
        omega, de, w2, partial, n_w, M, n_chunks, tw, eta2);
  } else {
    lorentz_partial_kernel<1><<<grid, kThreads, 0, stream>>>(
        omega, de, w2, partial, n_w, M, n_chunks, tw, eta2);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((n_w + kThreads - 1) / kThreads, batch);
  const float scale = static_cast<float>(static_cast<double>(eta) /
                                         3.14159265358979323846);
  lorentz_finalize_kernel<<<grid2, kThreads, 0, stream>>>(partial, out, n_w,
                                                          n_chunks, scale);
  return static_cast<int>(cudaGetLastError());
}
