// K1: damped Jacobi rotation generator S of the tracked eigensolver.
//
// Replaces dwavehmc_tpu/ops/pallas_kernels.py::rotation_s_parts (its body
// _rot_s_kernel).  For T = U^H H U given as (tr, ti) and its diagonal d:
//
//   gap   = d[col] - d[row]
//   theta = min(0.5 * atan2(2|T|, |gap|), smax)
//   S     = (T/|T|) * theta * sign(gap + 1e-30),  0 on the diagonal and
//           where |T| <= 1e-30
//
// Bound: memory.  Per chain it reads tr and ti and writes sr and si, 16 n^2
// bytes (about 21 MB at n = 1152), against some twenty flops and one atan2f
// per element.  Design: one thread per element; a block covers 256
// neighbouring columns of one row, so every load and store is coalesced and
// d[row] is one broadcast read per block; grid z walks the chains.  The
// ragged edge is masked, nothing is padded.  atan2f is called directly (the
// TPU kernel's odd series existed only because Mosaic has no atan2), and the
// element arithmetic keeps the plain PyTorch version's rounding: products
// and sums are not fused, and NaN propagates as torch.minimum propagates it.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void rotation_s_kernel(const float* __restrict__ tr,
                                  const float* __restrict__ ti,
                                  const float* __restrict__ d,
                                  float* __restrict__ sr,
                                  float* __restrict__ si,
                                  int n, float smax) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  const long long b = blockIdx.z;
  if (col >= n) return;
  const float* db = d + b * n;
  const long long idx = (b * n + row) * static_cast<long long>(n) + col;
  const float a = tr[idx];
  const float c = ti[idx];
  const float gap = db[col] - db[row];
  const float mag = sqrtf(__fadd_rn(__fmul_rn(a, a), __fmul_rn(c, c)));
  float theta = 0.5f * atan2f(2.0f * mag, fabsf(gap));
  theta = theta > smax ? smax : theta;
  const bool ok = mag > 1e-30f;
  const float den = ok ? mag : 1e-30f;
  const float pr = ok ? a / den : 0.0f;
  const float pi = ok ? c / den : 0.0f;
  const float g = gap + 1e-30f;
  const float sgn = static_cast<float>((g > 0.0f) - (g < 0.0f));
  const float mask = row != col ? 1.0f : 0.0f;
  sr[idx] = pr * theta * sgn * mask;
  si[idx] = pi * theta * sgn * mask;
}

}  // namespace

// tr, ti, sr, si: (batch, n, n) row-major float32; d: (batch, n).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dwh_rotation_s_parts(const float* tr, const float* ti,
                                    const float* d, float* sr, float* si,
                                    int batch, int n, float smax,
                                    cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, n, batch);
  rotation_s_kernel<<<grid, kThreads, 0, stream>>>(tr, ti, d, sr, si, n,
                                                   smax);
  return static_cast<int>(cudaGetLastError());
}
