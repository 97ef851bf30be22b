// The halving tree that K3, K4 (chain_sum.cu) and K5 (sigma_cap.cu) add in.
//
//   pad the row with zeros to P = max(256, next power of two >= m);
//   for h = P/2, P/4, ..., 1:  x[i] = x[i] + x[i + h]  for i < h;
//   the sum is x[0].
//
// The tree fixes which pairs are added, not which thread holds them: any
// mapping of the index bits to registers, lanes, warps and blocks gives the
// same bits as long as the levels are added top bit first.  Every add and
// product is rounded on its own (__fmul_rn, __fadd_rn and their double
// forms), so nvcc cannot fuse them.
//
// Helpers:
//   register_levels  the levels held in one thread's registers;
//   block_levels     the levels across a block (shared memory, then shuffles);
//   pair_levels      the tree of adjacent pairs over G values;
//   counter_push     a binary counter that merges chunk sums in walk order;
//   walk_leaf        leaf u of the bit-reversed walk.
// A thread that holds the elements y_q = x[t + T*q] of a tree whose levels
// h >= T are a halving tree over q folds them as it loads them: walked in
// the bit-reversed order of q, that tree is the tree of adjacent pairs,
// which pair_levels and counter_push add as they go.
#pragma once

#include <cuda_runtime.h>

namespace halving_tree {

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

}  // namespace halving_tree
