// K6: W = H·U for the BdG Hamiltonian H, applied through the columns where
// a row of H can be nonzero (the tracked eigensolver's float32 IEEE
// projections T = U^H (H U)).
//
// Replaces no TPU kernel.  The JAX package leaves H·U to XLA's dense matmul,
// as the port left it to cuBLAS, and both multiply out the 2N - 13 zeros of
// every row of H; this kernel reads only H's own entries.
//
// For each chain and row r:
//
//   W[r, :] = sum_{k < nnz[r]} H[r, cols[r, k]] * U[cols[r, k], :]
//
// in complex arithmetic (the 4-multiplication form), summed in table order
// in float32 registers and written once.  The coefficients are read in place
// from hr and hi; the table (cols, nnz) is built once a lattice on the host
// (ops/kernels.bdg_hop_table), as are the CTAs' row blocks and halos.
//
// Bound: memory.  Per chain it reads U and writes W, 16 n^2 bytes (21.2 MB
// at n = 1152), and reads 26 n coefficients.  Each output element takes 13
// complex multiply-adds (52 fused operations) from values already on chip,
// two 16-byte shared-memory loads a term: the shared-memory bandwidth comes
// next after the device memory's.
//
// Design:
// - A CTA produces one row block of one chain: the particle and the hole
//   rows of R/2 consecutive sites (R = 16, ops/kernels.BDG_HOP_ROWS).  The
//   two rows of a site read the same sites of both Nambu blocks, so the
//   block's halo (the distinct rows of U its rows read, listed on the host)
//   holds 60 rows of U at 24x24 where its 16 rows alone read 208.
// - The CTA walks the columns in chunks of 32.  The halo's chunk is copied
//   into shared memory with cp.async, 16 bytes a thread and a row's 128
//   bytes by 8 neighbouring threads, while the previous chunk is computed
//   (two stages, one barrier a chunk).  The copy zero-fills past the
//   ragged edge.
// - A thread owns one row and 4 columns of a chunk.  It keeps the row's
//   coefficients and halo offsets (two to a register) in registers for the
//   whole walk; the 8 threads of a row read one 128-byte row segment, free
//   of bank conflicts.  Small CTAs of 80 registers a thread keep 24 warps
//   an SM: on an H100, (64, 1152) took 0.64 ms at R = 16 against 0.66-0.75
//   at R = 32 or 64, with 3 or 4 stages, fewer registers or 8 columns a
//   thread (PERF.md).
// - Grid: chain-major, so one chain's U (10.6 MB at n = 1152) stays in the
//   50 MB L2 while its blocks read it, and each row of U comes from device
//   memory about once.
// - Rows that are not 16-byte aligned (n not a multiple of 4, tiny
//   lattices) are loaded and stored one float at a time.
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kK = 13;        // table width: the most columns a row holds
constexpr int kGroups = 8;    // float4 column groups of a chunk
constexpr int kChunk = 4 * kGroups;
constexpr int kMaxThreads = 512;
constexpr int kStages = 2;    // chunks of the halo in shared memory
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;  // devices whose attribute is remembered

__device__ __forceinline__ void copy16(float4* dst, const float* src,
                                       int bytes) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :
               : "r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait for all but the ``kPending`` copy groups committed last.
template <int kPending>
__device__ __forceinline__ void wait_all_but() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The halo's chunk of columns [c0, c0 + 32) of ur and ui into stage ``st``
// (re: st[0 .. hmax*8), im: after it).  Thread (g, y) of a CTA of R rows
// copies column group g of halo entries y, y + R, ... (real parts first).
__device__ __forceinline__ void stage(float4* st, const float* ur,
                                      const float* ui, const int* shalo,
                                      int hmax, int n, int c0, bool vec) {
  const int g = threadIdx.x;
  const int col = c0 + 4 * g;
  const int left = n - col;
  const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
  for (int hp = threadIdx.y; hp < 2 * hmax; hp += blockDim.y) {
    const int part = hp >= hmax;
    const int src_row = shalo[hp - part * hmax];
    if (src_row < 0) continue;
    const float* src = (part ? ui : ur) + static_cast<long long>(src_row) * n;
    float4* dst = st + hp * kGroups + g;
    if (vec) {
      copy16(dst, src + (bytes ? col : 0), bytes);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = e < left ? src[col + e] : 0.0f;
      *dst = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ void term(float4& ar, float4& ai, float cr,
                                     float ci, const float4& u,
                                     const float4& v) {
  ar.x = fmaf(cr, u.x, ar.x); ar.x = fmaf(-ci, v.x, ar.x);
  ar.y = fmaf(cr, u.y, ar.y); ar.y = fmaf(-ci, v.y, ar.y);
  ar.z = fmaf(cr, u.z, ar.z); ar.z = fmaf(-ci, v.z, ar.z);
  ar.w = fmaf(cr, u.w, ar.w); ar.w = fmaf(-ci, v.w, ar.w);
  ai.x = fmaf(cr, v.x, ai.x); ai.x = fmaf(ci, u.x, ai.x);
  ai.y = fmaf(cr, v.y, ai.y); ai.y = fmaf(ci, u.y, ai.y);
  ai.z = fmaf(cr, v.z, ai.z); ai.z = fmaf(ci, u.z, ai.z);
  ai.w = fmaf(cr, v.w, ai.w); ai.w = fmaf(ci, u.w, ai.w);
}

__device__ __forceinline__ void put(float* w, const float4& a, int left,
                                    bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(w) = a;
    return;
  }
  const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < left) w[e] = v[e];
}

// blockDim (8, R); grid: chain-major over (chain, row block); kStages
// chunks of the halo in shared memory, kStages - 1 of them in flight while
// one is computed.
__global__ void __launch_bounds__(kMaxThreads)
    bdg_hop_kernel(const float* __restrict__ hr, const float* __restrict__ hi,
                   const float* __restrict__ ur, const float* __restrict__ ui,
                   float* __restrict__ wr, float* __restrict__ wi,
                   const int* __restrict__ cols, const int* __restrict__ nnz,
                   const int* __restrict__ rows, const int* __restrict__ halo,
                   const int* __restrict__ lidx, int n, int nblk, int hmax,
                   int vec_in) {
  extern __shared__ float4 smem[];
  const bool vec = vec_in != 0;
  const int R = blockDim.y;
  const int tid = threadIdx.y * kGroups + threadIdx.x;
  const long long b = blockIdx.x / nblk;
  const int blk = blockIdx.x - static_cast<int>(b) * nblk;
  const long long nn = static_cast<long long>(n) * n;
  const float* urb = ur + b * nn;
  const float* uib = ui + b * nn;
  const int stage_len = 2 * hmax * kGroups;
  int* shalo = reinterpret_cast<int*>(smem + kStages * stage_len);
  for (int h = tid; h < hmax; h += kGroups * R)
    shalo[h] = halo[static_cast<long long>(blk) * hmax + h];
  __syncthreads();

  const int row = rows[blk * R + threadIdx.y];
  int nk = 0;
  float cr[kK], ci[kK];
  // halo offsets of the terms, two 16-bit ones a register
  unsigned int off[(kK + 1) / 2];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    cr[k] = 0.0f;
    ci[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < (kK + 1) / 2; ++k) off[k] = 0;
  if (row >= 0) {
    nk = nnz[row];
    const long long base = b * nn + static_cast<long long>(row) * n;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (k < nk) {
        const int c = cols[row * kK + k];
        cr[k] = hr[base + c];
        ci[k] = hi[base + c];
      }
      off[k / 2] |= static_cast<unsigned int>(lidx[row * kK + k] * kGroups)
                    << (16 * (k % 2));
    }
  }

  const int chunks = (n + kChunk - 1) / kChunk;
#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) {
    if (ch < chunks)
      stage(smem + ch * stage_len, urb, uib, shalo, hmax, n, ch * kChunk,
            vec);
    commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    // chunk ch has landed, and every thread is done with chunk ch - 1,
    // whose stage the copy of chunk ch + kStages - 1 takes
    wait_all_but<kStages - 2>();
    __syncthreads();
    const int next = ch + kStages - 1;
    if (next < chunks)
      stage(smem + (next % kStages) * stage_len, urb, uib, shalo, hmax, n,
            next * kChunk, vec);
    commit();
    const int col = ch * kChunk + 4 * threadIdx.x;
    if (row >= 0 && col < n) {
      const float4* sre = smem + (ch % kStages) * stage_len;
      const float4* sim = sre + hmax * kGroups;
      float4 ar = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 ai = ar;
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (k < nk) {
          const int o = ((off[k / 2] >> (16 * (k % 2))) & 0xffffu) +
                        threadIdx.x;
          term(ar, ai, cr[k], ci[k], sre[o], sim[o]);
        }
      }
      const long long at = b * nn + static_cast<long long>(row) * n + col;
      put(wr + at, ar, n - col, vec);
      put(wi + at, ai, n - col, vec);
    }
  }
}

}  // namespace

// hr, hi, ur, ui, wr, wi: (batch, n, n) row-major float32; cols, lidx:
// (n, 13) int32; nnz: (n,); rows: (nblk, rows_per_block), -1 past the last
// row; halo: (nblk, hmax), -1 past a block's last halo row.  ``vec``: every
// row is 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int dwh_bdg_hop(const float* hr, const float* hi, const float* ur,
                           const float* ui, float* wr, float* wi,
                           const int* cols, const int* nnz, const int* rows,
                           const int* halo, const int* lidx, int batch, int n,
                           int nblk, int rows_per_block, int hmax, int vec,
                           cudaStream_t stream) {
  // The shared-memory limit is an attribute of the kernel on each device
  // (a CTA takes 61.7 KB at 24x24, above the default 48 KB): set it once a
  // device, and on every call past kMaxDevices.
  static std::atomic<bool> prepared[kMaxDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool known = device < kMaxDevices;
  if (!known || !prepared[device].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(bdg_hop_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (known) prepared[device].store(true, std::memory_order_release);
  }
  const size_t smem =
      static_cast<size_t>(kStages) * 2 * hmax * kGroups * sizeof(float4) +
      static_cast<size_t>(hmax) * sizeof(int);
  const dim3 block(kGroups, rows_per_block);
  bdg_hop_kernel<<<batch * nblk, block, smem, stream>>>(
      hr, hi, ur, ui, wr, wi, cols, nnz, rows, halo, lidx, n, nblk, hmax,
      vec);
  return static_cast<int>(cudaGetLastError());
}
