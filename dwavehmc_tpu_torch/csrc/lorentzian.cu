// K2: weighted Lorentzian sum of the optical and DC conductivity.
//
// Replaces dwavehmc_tpu/ops/pallas_kernels.py::weighted_lorentzian_sum (its
// body _lorentz_kernel).  For every chain b and frequency k:
//
//   S[b, k] = sum_i w2[b, i] * (eta/pi) / ((omega[b, k] - de[b, i])^2 + eta^2)
//
// for any de and any signed w2, without ever holding the (n_omega x M)
// Lorentzian block in memory.
//
// Bound: operations.  At 24x24 one chain has M = 1,327,104 pairs and
// n_omega = 1436 frequencies, 1.9e9 Lorentzians against 8 M + 8 n_omega
// bytes of input.  Counted as 6 flops each, 8 chains need 1.37 ms at the
// 67 TFLOP/s FP32 peak.  What limits a real kernel is the issue slot and the
// special function unit (SFU): an SM issues 4 warp instructions a clock and
// its SFU returns 16 reciprocals a clock, an eighth of the FP32 rate.  One
// reciprocal per Lorentzian would cost 3.6 ms at 1.98 GHz on the SFU alone,
// and a correctly rounded one (__frcp_rn) costs about 9 issued instructions.
//
// Design.
// - Two Lorentzians share one reciprocal: w1/a + w2/b = (w1 b + w2 a)/(a b),
//   taken with rcp.approx.ftz (one MUFU.RCP, about 1 ulp).  Per two
//   Lorentzians: 2 x (FADD + FFMA) for a and b, FMUL + FFMA for the
//   numerator, FMUL for a b, MUFU and the accumulating FFMA: 4.5 issued
//   instructions and half an SFU op each, so issue (~2.0 ms) and SFU
//   (~1.8 ms) are nearly balanced.  The compiled loop (8 doubles x R = 5,
//   unrolled) is 373 instructions for 80 Lorentzians, 4.66 each, so issue
//   bounds it: 2.12 ms at 1.98 GHz for the 8-chain call, against 1.83 ms on
//   the SFU and the 1.37 ms operations bound.  On an H100 at 700 W it runs
//   in 2.73 ms (chip_smoke.py).  Groups of three take a third of an SFU op
//   each but issue more instructions, and ran no faster on the H100;
//   groups of four cost more still.  The combined fraction is exact to a
//   few ulp while a b and its reciprocal stay normal floats: eta in
//   [1e-9, 1e9] (checked per launch), |omega|, |de| <= 1e9 and |w2| <= 1e18
//   (checked per block on the data the block holds).  A block outside that
//   range takes one approximate reciprocal per Lorentzian.
// - The launch geometry comes from the caller (ops/kernels.py::
//   _lorentzian_launch): a frequency tile of tile_w threads x R frequencies
//   in registers, cut so the columns computed barely exceed n_omega
//   (1436 -> 288 x 5 = 1440), and pair_lanes threads splitting each chunk's
//   pairs (1 for the optical call, 256 for the one-frequency DC call).  With
//   one pair lane the loop stride is a compile-time 1, so the unrolled loop
//   addresses shared memory by immediate offsets.
// - A block stages one chunk of pairs in shared memory as float4
//   (de0, w0, de1, w1): one 16-byte broadcast load feeds two pairs to R
//   frequencies.  Pass 1 writes one partial per (chunk, frequency), after a
//   fixed tree over the pair lanes; pass 2 sums the partials in chunk order.
//   There are no float atomics, so a run repeats bit for bit.  Zero-weight
//   pairs are computed like any other, so the time depends on the shapes
//   only.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 32;

__device__ __forceinline__ float rcp_approx_ftz(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Dynamic shared memory: chunk/2 float4 pairs, then (pair_lanes > 1 only)
// R x blockDim.x floats for the tree, then kMaxWarps floats for the range
// check.  The caller sizes it (smem_bytes) by the same rule.
template <int R, bool kOneLane>
__global__ void lorentz_partial_kernel(const float* __restrict__ omega,
                                       const float* __restrict__ de,
                                       const float* __restrict__ w2,
                                       float* __restrict__ partial, int n_w,
                                       int M, int chunk, int n_chunks,
                                       int tile_w, int pair_lanes, float eta2,
                                       bool eta_in_range) {
  extern __shared__ float4 s_pairs[];
  const int n_threads = blockDim.x;
  const int n_q = chunk / 2;
  float* s_red = reinterpret_cast<float*>(s_pairs + n_q);
  float* s_max = s_red + (pair_lanes > 1 ? R * n_threads : 0);

  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const long long b = blockIdx.z;
  const long long p0 = static_cast<long long>(c) * chunk;
  const float* de_b = de + b * M;
  const float* w2_b = w2 + b * M;

  // Stage the chunk; padding past M is (de, w2) = (0, 0).  Track the
  // largest |de| (scaled by 1e9) and |w2| for the range check.
  float big = 0.0f;
  for (int j = tid; j < n_q; j += n_threads) {
    const long long g = p0 + 2 * j;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g < M) {
      v.x = de_b[g];
      v.y = w2_b[g];
    }
    if (g + 1 < M) {
      v.z = de_b[g + 1];
      v.w = w2_b[g + 1];
    }
    s_pairs[j] = v;
    big = fmaxf(big, fmaxf(1e9f * fmaxf(fabsf(v.x), fabsf(v.z)),
                           fmaxf(fabsf(v.y), fabsf(v.w))));
  }

  const int lane = tid % tile_w;     // frequency lane
  const int q = tid / tile_w;        // pair lane
  const int w_base = blockIdx.y * tile_w * R;
  float om[R];
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = w_base + r * tile_w + lane;
    om[r] = w < n_w ? omega[b * n_w + w] : 0.0f;
    acc[r] = 0.0f;
    big = fmaxf(big, 1e9f * fabsf(om[r]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, off));
  if (tid % 32 == 0) s_max[tid / 32] = big;
  __syncthreads();
  for (int i = 0; i < (n_threads + 31) / 32; ++i) big = fmaxf(big, s_max[i]);
  const bool combine = eta_in_range && big <= 1e18f;

  const int stride = kOneLane ? 1 : pair_lanes;
  const int j0 = kOneLane ? 0 : q;
  const int n_valid = static_cast<int>(min(static_cast<long long>(n_q),
                                           (M - p0 + 1) / 2));
  if (combine) {
#pragma unroll 8
    for (int j = j0; j < n_valid; j += stride) {
      const float4 v = s_pairs[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x1 = om[r] - v.x;
        const float x2 = om[r] - v.z;
        const float a = fmaf(x1, x1, eta2);
        const float bb = fmaf(x2, x2, eta2);
        const float num = fmaf(v.y, bb, v.w * a);
        acc[r] = fmaf(num, rcp_approx_ftz(a * bb), acc[r]);
      }
    }
  } else {
    for (int j = j0; j < n_valid; j += stride) {
      const float4 v = s_pairs[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x1 = om[r] - v.x;
        const float x2 = om[r] - v.z;
        acc[r] = fmaf(v.y, rcp_approx(fmaf(x1, x1, eta2)), acc[r]);
        acc[r] = fmaf(v.w, rcp_approx(fmaf(x2, x2, eta2)), acc[r]);
      }
    }
  }

  if (!kOneLane) {
#pragma unroll
    for (int r = 0; r < R; ++r) s_red[r * n_threads + tid] = acc[r];
    __syncthreads();
    for (int s = pair_lanes / 2; s > 0; s >>= 1) {
      if (q < s) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          s_red[r * n_threads + tid] +=
              s_red[r * n_threads + tid + s * tile_w];
      }
      __syncthreads();
    }
    if (q != 0) return;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = s_red[r * n_threads + lane];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w = w_base + r * tile_w + lane;
    if (w < n_w) partial[(b * n_chunks + c) * n_w + w] = acc[r];
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

// omega, out: (batch, n_w); de, w2: (batch, M); partial: scratch of
// (batch, n_chunks, n_w) floats.  The geometry comes from ops/kernels.py::
// _lorentzian_launch: tile_w frequency lanes x R frequencies per thread,
// pair_lanes a power of two, tile_w * pair_lanes whole warps (at most 1024
// threads), chunk even, n_chunks * chunk >= M, smem_bytes as above.
// Returns the first nonzero cudaError_t of the two launches (0 on success;
// cudaErrorInvalidValue for a geometry without an instantiation).
extern "C" int dwh_weighted_lorentzian_sum(
    const float* omega, const float* de, const float* w2, float* partial,
    float* out, int batch, int n_w, int M, int tile_w, int R, int pair_lanes,
    int chunk, int n_chunks, int smem_bytes, float eta, cudaStream_t stream) {
  const int threads = tile_w * pair_lanes;
  const dim3 grid(n_chunks, (n_w + tile_w * R - 1) / (tile_w * R), batch);
  const float eta2 = eta * eta;
  const bool eta_in_range = fabsf(eta) >= 1e-9f && fabsf(eta) <= 1e9f;
  // Wide calls: one pair lane, R = 4..8.  Narrow calls: R = 1, many lanes.
  using Kernel = void (*)(const float*, const float*, const float*, float*,
                          int, int, int, int, int, int, float, bool);
  Kernel kernel = nullptr;
  if (pair_lanes == 1) {
    switch (R) {
      case 4: kernel = lorentz_partial_kernel<4, true>; break;
      case 5: kernel = lorentz_partial_kernel<5, true>; break;
      case 6: kernel = lorentz_partial_kernel<6, true>; break;
      case 7: kernel = lorentz_partial_kernel<7, true>; break;
      case 8: kernel = lorentz_partial_kernel<8, true>; break;
    }
  } else if (R == 1) {
    kernel = lorentz_partial_kernel<1, false>;
  }
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, threads, smem_bytes, stream>>>(omega, de, w2, partial, n_w,
                                                M, chunk, n_chunks, tile_w,
                                                pair_lanes, eta2,
                                                eta_in_range);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((n_w + 255) / 256, batch);
  const float scale = static_cast<float>(static_cast<double>(eta) /
                                         3.14159265358979323846);
  lorentz_finalize_kernel<<<grid2, 256, 0, stream>>>(partial, out, n_w,
                                                     n_chunks, scale);
  return static_cast<int>(cudaGetLastError());
}
