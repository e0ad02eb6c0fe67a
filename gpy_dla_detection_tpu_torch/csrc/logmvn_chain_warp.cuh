// K3's warp chain: the Cholesky factor of I + B for one sample on one
// warp, with the forward substitution of u fused in, as K3
// (logmvn_chain.cu) runs it.  Shared by K3 and by K7's two kernels
// (logmvn_ablate.cu: the stage kernel's full and chain_nodot, and the flat
// chain), so the three run one chain.
//
// B is a packed lower triangle, column-major: column c holds rows c..k-1
// contiguously, entry (row, c) at off(c) + row - c with off(c + 1) = off(c)
// + k - c.  Lane a owns row a, entries (a, 0..a), and u_a, in arrays
// indexed only at compile time: the loops are unrolled over a row bound
// KMAX (32, or 64 with lane a also owning row a + 32), and k <= KMAX is
// taken at run time by one warp-uniform guard a step.  Step j is
// left-looking:
//   - lane j adds the 1 of I to its diagonal; each lane subtracts
//     l_ac l_jc from its entry (a, j), c = 0..j-1, with l_jc broadcast from
//     lane j by __shfl_sync; lane j's own entry becomes the pivot d_j;
//   - d_j is broadcast, lane j keeps it, and every lane scales its entry
//     (a, j) by rsqrt(d_j);
//   - t_j = u_j rsqrt(d_j) is broadcast, quad += t_j^2, u_a -= t_j l_aj.
// After the last step each lane takes logf of its own pivot, and logdet
// sums them j = 0..k-1 through shuffles (one logf a lane, not one a step).
// Every entry meets the same FMAs in the same order (c ascending) as in a
// right-looking rank-1 chain, and quad and logdet are summed j = 0..k-1 as
// there.  A lane's entries above its diagonal, and the rows past k - 1,
// hold values that nothing reads.
//
// kNoDot: the ablation's chain without its dot (scripts/kernel_ablate.py,
// chain_nodot), wrong on purpose: at step j every later row i loses
// col_j[a]^2 in every column a, so the entry (j, a) that step j reads is
// B[j, a] + I - sum_{c<j} l_ac^2: lane a's own entries only, no shuffle.
// The product and the difference are rounded apart, as the plain twin
// rounds them.  NaN wherever a pivot goes negative.

#pragma once

#include <cuda_runtime.h>

namespace k3 {

constexpr unsigned kFull = 0xffffffffu;

// warps a block and blocks an SM (the launch bound) at row bounds 32 and 64
template <int W32, int B32, int W64, int B64>
struct GeometryOf {
  __host__ __device__ static constexpr int warps(int kmax) { return kmax == 32 ? W32 : W64; }
  __host__ __device__ static constexpr int blocks(int kmax) { return kmax == 32 ? B32 : B64; }
};

// Lane a's rows of the packed triangle at tri.  Entries above a lane's
// diagonal, and rows past k - 1, read whatever the memory holds up to
// tri + k(k+1)/2 + KMAX; nothing reads them back.
template <int KMAX>
__device__ __forceinline__ void load_rows(const float* tri, int k,
                                          float (&r)[KMAX / 32][KMAX]) {
  constexpr int Q = KMAX / 32;
  const int a = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float* p = tri + q * 32 + a;
#pragma unroll
    for (int c = 0; c < (q + 1) * 32; ++c) {
      r[q][c] = c < k ? *p : 0.0f;
      p += k - 1 - c;
    }
  }
}

// The factorization and the substitution: quad = sum t_j^2 and logdet =
// sum log d_j, the same in every lane.
template <int KMAX, bool kNoDot>
__device__ __forceinline__ void factor(float (&r)[KMAX / 32][KMAX], float (&uq)[KMAX / 32],
                                       int k, float& quad, float& logdet) {
  constexpr int Q = KMAX / 32;
  const int a = threadIdx.x & 31;
  quad = 0.0f;
  float piv[Q];  // the pivots of the lane's rows
#pragma unroll
  for (int q = 0; q < Q; ++q) piv[q] = 1.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      const int qj = j / 32;  // lane lj, slot qj holds row j
      const int lj = j % 32;
      if (a == lj) r[qj][j] += 1.0f;  // + I, before the column's updates
#pragma unroll
      for (int c = 0; c < j; ++c) {
        if constexpr (kNoDot) {
#pragma unroll
          for (int q = 0; q < Q; ++q)
            if (j < (q + 1) * 32) r[q][j] = __fsub_rn(r[q][j], __fmul_rn(r[q][c], r[q][c]));
        } else {
          const float l = __shfl_sync(kFull, r[qj][c], lj);
#pragma unroll
          for (int q = 0; q < Q; ++q)
            if (j < (q + 1) * 32) r[q][j] -= r[q][c] * l;
        }
      }
      const float d = __shfl_sync(kFull, r[qj][j], lj);
      if (a == lj) piv[qj] = d;
      const float inv = rsqrtf(d);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (j < (q + 1) * 32) r[q][j] *= inv;
      const float t = __shfl_sync(kFull, uq[qj], lj) * inv;
      quad += t * t;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (j < (q + 1) * 32) uq[q] -= t * r[q][j];
    }
  }
  // one logf a lane, then the pivots' logs summed j = 0..k-1 in order
  float lg[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) lg[q] = logf(piv[q]);
  logdet = 0.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) logdet += __shfl_sync(kFull, lg[j / 32], j % 32);
}

// One sample whose triangle, u (k floats) and misc = (quad0, logdet0 + n
// log 2 pi) lie in shared memory: ll = -1/2 (quad0 - quad + logdet0 +
// logdet), the same in every lane.
template <int KMAX, bool kNoDot>
__device__ __forceinline__ float chain_ll(const float* tri, const float* uu, float m0,
                                          float m1, int k) {
  constexpr int Q = KMAX / 32;
  const int a = threadIdx.x & 31;
  float uq[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int row = q * 32 + a;
    uq[q] = row < k ? uu[row] : 0.0f;
  }
  float r[Q][KMAX];
  load_rows<KMAX>(tri, k, r);
  float quad, logdet;
  factor<KMAX, kNoDot>(r, uq, k, quad, logdet);
  return -0.5f * (m0 - quad + m1 + logdet);
}

}  // namespace k3
