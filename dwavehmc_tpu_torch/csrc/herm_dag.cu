// K7: C = A^H B for complex A = ar + i ai and B = br + i bi, (batch, n, n)
// row-major float32 each, where the caller knows that C is Hermitian (the
// tracked eigensolver's projection T = U^H (H U) and Newton-Schulz Gram
// matrix G = U^H U, in float32 IEEE).
//
// Replaces no TPU kernel.  The JAX package leaves A^H B to XLA's dense
// products (ops/tracked_eigh.py::cmm_dag), as the port left it to cuBLAS:
// three or four real GEMMs over the whole n x n output and 2-5 elementwise
// passes for the pre-adds and the combines.  This kernel computes only the
// 64 x 64 output tiles on and below the diagonal, all the real products of
// one call from operand tiles staged once, and writes every entry i >= j
// and its mirror: cr[j, i] = cr[i, j], ci[j, i] = -ci[i, j].  The diagonal
// is written as computed.
//
// Arithmetic: the two complex forms of cmm_dag, each real product summed
// on its own over k = 0, 1, ..., n - 1 in that order by one fused
// multiply-add a term in float32 registers (no TF32, no tensor cores), the
// combines in the epilogue, every operation rounded as the dense form
// rounds it:
//   karatsuba (precision None): m1 = ar^T br, m2 = ai^T bi,
//     m3 = (ar - ai)^T (br + bi), the pre-adds rounded to float32;
//     cr = m1 + m2, ci = (m3 - m1) + m2;
//   four ("highest"): cr = ar^T br + ai^T bi, ci = ar^T bi - ai^T br.
// A chain's sums do not depend on the batch.  On an H100 they came out
// bit-equal to cuBLAS's dense products at every shape tried.
//
// Bound: operations.  Over the lower triangle a chain takes
// P n^2 (n + 1) / 2 fused multiply-adds (P = 3 or 4 real products)
// against 16 n^2 bytes read and 8 n^2 written: at n = 1152 some 500
// operations a byte.  The FP32 pipes issue one warp instruction a cycle
// per SM sub-partition and shared memory serves 128 bytes a cycle per SM,
// so what bounds the kernel is the share of issue slots that are FFMA and
// the shared-memory bytes each FFMA needs.
//
// Design:
// - A CTA computes one 64 x 64 output tile of one chain; CTAs run over
//   (chain, lower-triangle tile), chain-major, so a chain's operands stay
//   in the 50 MB L2 while its tiles read them.
// - The CTA is P groups of 64 threads, one a real product.  A thread holds
//   8 x 8 sums of its group's product (rows and columns each two groups of
//   4, 32 apart) and reads per k two float4 of the rows' operand and two of
//   the columns' from shared memory: 64 FFMA against 4 shared loads, the
//   fewest loads an FFMA that 64 accumulators allow.  A warp is 4 x 8
//   threads, so each load is one 64- or 128-byte row segment.  Holding all
//   P products of 8 x 4 entries in one thread instead needs 9 (karatsuba)
//   loads a k for 96 FFMA and ran slower, as did 128 x 64 tiles, 8 x 16
//   sums a thread (spills) and 8-row stages (PERF.md, section 6).
// - Operands go into shared memory by cp.async, 16 bytes a thread, in
//   stages of 16 rows of k (4 stages, 3 in flight).  A^T B reads rows of A
//   and B alike, so each stage is rows k of both, contiguous, with no
//   transpose.  Rows past n and columns past n are zero-filled.
// - Karatsuba's pre-adds are formed once per staged element: one stage
//   ahead of the compute, the CTA forms (ar - ai) and (br + bi) of the next
//   stage into a second pair of buffers, so one barrier a stage serves
//   copy, pre-add and compute.
// - The epilogue: every group but group 2 leaves its sums in shared
//   memory; group 2 combines them with its own and stores the tile and its
//   mirror as float4.
// - Rows that are not 16-byte aligned (n not a multiple of 4, or storage
//   that is not) are loaded and stored one float at a time.
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kBK = 16;       // rows of k a stage
constexpr int kStages = 4;    // stages of the raw operands
constexpr int kMaxDevices = 64;  // devices whose attribute is remembered

__device__ __forceinline__ void copy16(float* dst, const float* src,
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float x, float y, float z,
                                    float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}

// A BM x BN output tile computed by P groups of threads, one a real
// product, each thread 8 x TN entries of its product.
template <int BM, int BN, int TN, int P>
struct Shape {
  static constexpr int kGroup = BM * BN / (8 * TN);  // threads a product
  static constexpr int kThreads = P * kGroup;
  static constexpr int kWX = BN / (8 * TN);  // warps along a row
  // a raw stage: ar, ai (kBK x BM each), then br, bi (kBK x BN each)
  static constexpr int kA = kBK * BM;
  static constexpr int kB = kBK * BN;
  static constexpr int kRaw = 2 * kA + 2 * kB;
  // a pre-add stage: ar - ai (kBK x BM), then br + bi (kBK x BN)
  static constexpr int kPre = kA + kB;
  static constexpr bool kKaratsuba = P == 3;
  // shared memory: the stages, or the epilogue's P - 1 products
  static constexpr int kStaged = kStages * kRaw + (kKaratsuba ? 2 * kPre : 0);
  static constexpr int kEpilogue = (P - 1) * BM * BN;
  static constexpr int kSmem = kStaged > kEpilogue ? kStaged : kEpilogue;
};

// Rows [k0, k0 + kBK) of the A columns [i0, i0 + BM) and of the B columns
// [j0, j0 + BN) of one chain into the raw stage ``st``; zeros past n.
template <class S>
__device__ __forceinline__ void stage(float* st, const float* ar,
                                      const float* ai, const float* br,
                                      const float* bi, int n, int k0, int i0,
                                      int j0, bool vec) {
  constexpr int kQuads = S::kRaw / 4;
  constexpr int kBM = S::kA / kBK, kBN = S::kB / kBK;
#pragma unroll
  for (int q0 = 0; q0 < kQuads; q0 += S::kThreads) {
    const int q = q0 + threadIdx.x;
    if (kQuads % S::kThreads != 0 && q >= kQuads) break;
    const int e = 4 * q;  // offset in the stage
    const float* src;
    int k, col;
    if (e < 2 * S::kA) {
      const int part = e / S::kA, r = e - part * S::kA;
      k = r / kBM;
      col = i0 + r - k * kBM;
      src = part ? ai : ar;
    } else {
      const int f = e - 2 * S::kA;
      const int part = f / S::kB, r = f - part * S::kB;
      k = r / kBN;
      col = j0 + r - k * kBN;
      src = part ? bi : br;
    }
    k += k0;
    const bool live = k < n;
    if (vec) {
      const bool in = live && col < n;
      copy16(st + e, src + (in ? static_cast<long long>(k) * n + col : 0),
             in ? 16 : 0);
    } else {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = live && col + c < n
                   ? src[static_cast<long long>(k) * n + col + c]
                   : 0.0f;
      st4(st + e, v[0], v[1], v[2], v[3]);
    }
  }
}

// Karatsuba's pre-adds of a landed raw stage: (ar - ai) and (br + bi).
template <class S>
__device__ __forceinline__ void pre_add(float* pre, const float* raw) {
  constexpr int kQuads = S::kPre / 4;
#pragma unroll
  for (int q0 = 0; q0 < kQuads; q0 += S::kThreads) {
    const int q = q0 + threadIdx.x;
    if (kQuads % S::kThreads != 0 && q >= kQuads) break;
    const int e = 4 * q;
    float4 x, y;
    if (e < S::kA) {
      x = ld4(raw + e);
      y = ld4(raw + S::kA + e);
      x.x -= y.x; x.y -= y.y; x.z -= y.z; x.w -= y.w;
    } else {
      const int f = e - S::kA;
      x = ld4(raw + 2 * S::kA + f);
      y = ld4(raw + 2 * S::kA + S::kB + f);
      x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
    }
    st4(pre + e, x.x, x.y, x.z, x.w);
  }
}

// Store entry (i, j) = (cr, ci) of the lower triangle and its mirror, for
// the thread's row group of 4 at ``i`` (rows i .. i + 3) and its 4 columns
// at ``j``: v[r][c] is entry (i + r, j + c).
__device__ __forceinline__ void put(float* cr, float* ci,
                                    const float (&vr)[4][4],
                                    const float (&vi)[4][4], int n, int i,
                                    int j, bool vec) {
  // the rows: (i + r, j .. j + 3) where j + c <= i + r
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = i + r;
    if (row >= n) continue;
    const long long at = static_cast<long long>(row) * n + j;
    if (vec && j + 3 <= row && j + 3 < n) {
      st4(cr + at, vr[r][0], vr[r][1], vr[r][2], vr[r][3]);
      st4(ci + at, vi[r][0], vi[r][1], vi[r][2], vi[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j + c <= row && j + c < n) {
          cr[at + c] = vr[r][c];
          ci[at + c] = vi[r][c];
        }
    }
  }
  // the mirror: (j + c, i .. i + 3) where i + r > j + c
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int row = j + c;
    if (row >= n) continue;
    const long long at = static_cast<long long>(row) * n + i;
    if (vec && i > row && i + 3 < n) {
      st4(cr + at, vr[0][c], vr[1][c], vr[2][c], vr[3][c]);
      st4(ci + at, -vi[0][c], -vi[1][c], -vi[2][c], -vi[3][c]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i + r > row && i + r < n) {
          cr[at + r] = vr[r][c];
          ci[at + r] = -vi[r][c];
        }
    }
  }
}

// The lower-triangle tiles of an n x n output in BM x BN tiles: row tile I
// holds column tiles J with J * BN <= (I + 1) * BM - 1.
__host__ __device__ __forceinline__ int row_tiles(int I, int n, int bm,
                                                  int bn) {
  const int nj = (n + bn - 1) / bn;
  const int c = ((I + 1) * bm - 1) / bn + 1;
  return c < nj ? c : nj;
}

int lower_tiles(int n, int bm, int bn) {
  int t = 0;
  for (int I = 0; I * bm < n; ++I) t += row_tiles(I, n, bm, bn);
  return t;
}

// The thread's 8 x TN entries of its product, at (row, column) offsets
// ``ri(g) + r`` and ``cj(h) + c`` of the tile, g < 2, h < TN / 4, r, c < 4.
template <int BM, int BN, int TN>
struct Frag {
  int ty, tx;
  __device__ __forceinline__ int ri(int g) const {
    return g * (BM / 2) + ty * 4;
  }
  __device__ __forceinline__ int cj(int h) const {
    return h * (BN / (TN / 4)) + tx * 4;
  }
};

// blockDim P * BM * BN / (8 TN); grid: (chain, lower tile), chain-major.
// Group p = threadIdx.x / (BM * BN / (8 TN)) runs real product p: karatsuba
// (P = 3) ar^T br, ai^T bi, (ar - ai)^T (br + bi); four (P = 4) ar^T br,
// ai^T bi, ar^T bi, ai^T br.  Group 2 combines: the others leave their
// sums in shared memory.
template <int BM, int BN, int TN, int P, int kMinBlocks>
__global__ void __launch_bounds__(Shape<BM, BN, TN, P>::kThreads, kMinBlocks)
    herm_dag_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                    const float* __restrict__ br, const float* __restrict__ bi,
                    float* __restrict__ cr, float* __restrict__ ci, int n,
                    int tiles, int vec_in) {
  using S = Shape<BM, BN, TN, P>;
  constexpr int kH = TN / 4;  // column groups of 4 a thread
  constexpr bool kKaratsuba = S::kKaratsuba;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* raw = smem;
  float* pre = smem + kStages * S::kRaw;
  const bool vec = vec_in != 0;

  const long long b = blockIdx.x / tiles;
  int t = static_cast<int>(blockIdx.x - b * tiles);
  int I = 0;
  for (;; ++I) {
    const int c = row_tiles(I, n, BM, BN);
    if (t < c) break;
    t -= c;
  }
  const int i0 = I * BM, j0 = t * BN;
  const long long nn = static_cast<long long>(n) * n;
  ar += b * nn;
  ai += b * nn;
  br += b * nn;
  bi += b * nn;

  // the group's product and the thread's place in it: a warp is 4 x 8
  // threads, so each operand load is one 64- or 128-byte row segment
  const int p = threadIdx.x / S::kGroup;
  const int lt = threadIdx.x - p * S::kGroup;
  const int lane = lt & 31, warp = lt >> 5;
  const Frag<BM, BN, TN> f{(warp / S::kWX) * 4 + (lane >> 3),
                           (warp % S::kWX) * 8 + (lane & 7)};
  // where the group's operands lie in a stage: (from the pre-add stage,
  // offset) for A and for B
  const bool a_pre = kKaratsuba && p == 2, b_pre = a_pre;
  const int a_off = a_pre ? 0 : ((p == 1 || p == 3) ? S::kA : 0);
  const int b_off = b_pre ? S::kA
                          : 2 * S::kA + ((p == 1 || p == 2) ? S::kB : 0);

  float acc[8][TN];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;

  const int T = (n + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T)
      stage<S>(raw + s * S::kRaw, ar, ai, br, bi, n, s * kBK, i0, j0, vec);
    commit();
  }
  if constexpr (kKaratsuba) {
    wait_all_but<kStages - 2>();
    __syncthreads();
    pre_add<S>(pre, raw);
  }
  for (int kt = 0; kt < T; ++kt) {
    // karatsuba: stage kt + 1 has landed for its pre-add (stage kt's was
    // formed a step ago); four: stage kt has landed.  Every thread is done
    // with stage kt - 1, whose buffers the copy of stage kt + kStages - 1
    // and the pre-add of stage kt + 1 take.
    if constexpr (kKaratsuba)
      wait_all_but<kStages - 3>();
    else
      wait_all_but<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < T)
      stage<S>(raw + (next % kStages) * S::kRaw, ar, ai, br, bi, n,
               next * kBK, i0, j0, vec);
    commit();
    if (kKaratsuba && kt + 1 < T)
      pre_add<S>(pre + ((kt + 1) & 1) * S::kPre,
                 raw + ((kt + 1) % kStages) * S::kRaw);

    const float* st = raw + (kt % kStages) * S::kRaw;
    const float* pst = pre + (kt & 1) * S::kPre;
    const float* sa = (a_pre ? pst : st) + a_off + f.ri(0);
    const float* sb = (b_pre ? pst : st) + b_off + f.cj(0);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = ld4(sa + k * BM), a1 = ld4(sa + k * BM + BM / 2);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bb[TN];
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const float4 v = ld4(sb + k * BN + h * (BN / kH));
        bb[4 * h] = v.x;
        bb[4 * h + 1] = v.y;
        bb[4 * h + 2] = v.z;
        bb[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], bb[c], acc[r][c]);
    }
  }

  // the epilogue: groups other than 2 leave their sums in shared memory
  // (slot p, or 2 for group 3), group 2 combines and stores
  __syncthreads();
  float* ep = smem;
  if (p != 2) {
    float* mine = ep + (p == 3 ? 2 : p) * BM * BN;
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int h = 0; h < kH; ++h)
          st4(mine + (f.ri(g) + r) * BN + f.cj(h), acc[4 * g + r][4 * h],
              acc[4 * g + r][4 * h + 1], acc[4 * g + r][4 * h + 2],
              acc[4 * g + r][4 * h + 3]);
  }
  __syncthreads();
  if (p != 2) return;
  cr += b * nn;
  ci += b * nn;
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      float vr[4][4], vi[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int at = (f.ri(g) + r) * BN + f.cj(h);
        const float4 e0 = ld4(ep + at), e1 = ld4(ep + BM * BN + at);
        const float x0[4] = {e0.x, e0.y, e0.z, e0.w};
        const float x1[4] = {e1.x, e1.y, e1.z, e1.w};
        float x2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (!kKaratsuba) {
          const float4 e2 = ld4(ep + 2 * BM * BN + at);
          x2[0] = e2.x; x2[1] = e2.y; x2[2] = e2.z; x2[3] = e2.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float mine = acc[4 * g + r][4 * h + c];
          vr[r][c] = x0[c] + x1[c];
          if constexpr (kKaratsuba)
            vi[r][c] = (mine - x0[c]) + x1[c];
          else
            vi[r][c] = mine - x2[c];
        }
      }
      put(cr, ci, vr, vi, n, i0 + f.ri(g), j0 + f.cj(h), vec);
    }
}

// The one tile shape: 64 x 64 outputs, 8 x 8 sums a thread, two CTAs an SM
// asked of the compiler (128 registers a thread for the four form).
constexpr int kTile = 64;
constexpr int kCols = 8;

template <int P>
using TileShape = Shape<kTile, kTile, kCols, P>;

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, float*, float*, int, int, int);

Kernel pick(int karatsuba) {
  return karatsuba ? herm_dag_kernel<kTile, kTile, kCols, 3, 2>
                   : herm_dag_kernel<kTile, kTile, kCols, 4, 2>;
}

size_t smem_bytes(int karatsuba) {
  return sizeof(float) *
         (karatsuba ? TileShape<3>::kSmem : TileShape<4>::kSmem);
}

int threads_of(int karatsuba) {
  return karatsuba ? TileShape<3>::kThreads : TileShape<4>::kThreads;
}

}  // namespace

// out: registers a thread, local (spilled) bytes a thread, threads a CTA,
// dynamic shared memory a CTA, CTAs an SM at that shared memory.
extern "C" int dwh_herm_dag_attrs(int karatsuba, int* out) {
  const Kernel k = pick(karatsuba);
  const size_t smem = smem_bytes(karatsuba);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k, threads_of(karatsuba), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = threads_of(karatsuba);
  out[3] = static_cast<int>(smem);
  out[4] = per_sm;
  return 0;
}

// ar, ai, br, bi, cr, ci: (batch, n, n) row-major float32.  ``karatsuba``:
// the 3-multiplication form, else the 4-multiplication one.  ``vec``: every
// row is 16-byte aligned.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int dwh_herm_dag(const float* ar, const float* ai, const float* br,
                            const float* bi, float* cr, float* ci, int batch,
                            int n, int karatsuba, int vec,
                            cudaStream_t stream) {
  // The shared-memory limit is an attribute of each kernel on each device
  // (a CTA takes 80 KB (karatsuba) or 64 KB, above the default 48 KB): set
  // it once a kernel and device, and on every call past kMaxDevices.
  static std::atomic<bool> prepared[2][kMaxDevices];
  const Kernel k = pick(karatsuba);
  const size_t smem = smem_bytes(karatsuba);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool known = device < kMaxDevices;
  std::atomic<bool>* flag =
      known ? &prepared[karatsuba != 0][device] : nullptr;
  if (!known || !flag->load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (known) flag->store(true, std::memory_order_release);
  }
  const int tiles = lower_tiles(n, kTile, kTile);
  const dim3 grid(static_cast<unsigned int>(batch) * tiles);
  k<<<grid, threads_of(karatsuba), smem, stream>>>(ar, ai, br, bi, cr, ci, n,
                                                   tiles, vec);
  return static_cast<int>(cudaGetLastError());
}
