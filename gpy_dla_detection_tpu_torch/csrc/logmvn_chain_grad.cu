// K3's adjoint: the gradient of K3's per-sample log-likelihood
//   ll = -1/2 (misc0 - u^T A^-1 u + misc1 + log det A),  A = I + B,
// with respect to its inputs, times the incoming gradient g of each sample:
//   dll/du = g v,  dll/dmisc = -g/2 in both columns,
//   dll/dB(i, j) = -g/2 (v_i v_j + (A^-1)_ij), twice that for i != j (the
//   packed entry stands for both halves of the symmetric matrix),
// with v = A^-1 u.  B is K3's packed lower triangle (column-major: column c
// holds rows c..k-1 contiguously, entry (row, c) at off(c) + row - c), and
// dB comes back in the same layout.
//
// Replaces: no TPU kernel.  The JAX training (gpy_dla_detection_tpu/
// models/training.py:234-276) differentiates batched_quad_logdet
// (gpy_dla_detection_tpu/ops/logmvn.py:111), K3's function, by autodiff of
// the unrolled chain; the port's training runs K3 forward and this kernel
// backward (ops/logmvn_kernels.chain_loglik).
//
// Bound on the card: the bytes, B, u and g read and dB, du and dmisc
// written, (k(k+1) + 2k + 3) floats a sample (7.6 MB, 0.0023 ms at
// S = 4,096, k = 20).  The work, ~k^3 FMAs a sample, is a chain of k
// dependent steps within a sample.
//
// Both kernels run Goodnight's symmetric sweep: A^-1 in place by k pivot
// steps, u riding along as one more column.  Step p, with d = A_pp (the
// Schur complement's diagonal: Cholesky's pivot d_p):
//   A_ij -= A_ip A_pj / d (i, j != p),  A_ip = A_pi = A_ip / d,  A_pp = -1/d;
// after the last step the matrix holds -A^-1 and the u column v = A^-1 u.
// Each step's work is independent across the matrix's entries, so the
// chain is k steps long, not the k^2 dependent broadcasts of a Cholesky
// inverse (the earlier design: factor, L^-1 column by column, A^-1 =
// L^-T L^-1).  A pivot that is not positive makes the sample's dB and du
// NaN, as K3 gives the sample a NaN likelihood.
//
// k <= 64, a warp a sample (logmvn_chain_grad_kernel): the full symmetric
// A in registers, lane a owning row a (and a + 32 at row bounds above 32),
// its u_a and a scale sig_a.  The loops are compiled for a row bound KMAX
// (24, 32 or 64: the smallest that holds k), the rows and
// columns past k - 1 zero, so a step is KMAX FMAs a row without a guard.
// Step p: each lane stores its true column-p entry sig_a A_ap into the
// warp's column buffer (two of them, alternating, so a step needs one
// __syncwarp), lane p its u_p; every lane reads the column back as
// broadcast float4 loads, d = the column's entry p, and updates its whole
// row with g_a = A_ap / d: A_aj -= g_a c_j.  Lane p's row is not rewritten:
// its true row after the step is its stored row over d, so lane p sets
// sig_p = 1/d and its stored entry p to -1 instead of scaling k entries.
// Lane i stores column j of dB from its own entry (i, j), i >= j (the
// lanes on consecutive floats), with v_j from the column buffer.
//
// k > 64, a warp a sample too (logmvn_chain_grad_wide_kernel): the packed
// triangle, u and the step's F in the warp's own buffer in shared memory,
// up to 8 warps a block (as K3's wide chain); past a block's shared bytes
// the same buffers in a global workspace, 4 warps a block.  The sweep takes
// its pivots kPivots at a time (a block sweep, the same function): each
// lane sweeps the 4 x 4 pivot block M_SS in registers (its four pivots are
// the checked d's), P = M_SS^-1; lanes over columns j store F_j = P E_j,
// E_j row j's entries in the pivot columns (F_u = P u_S); then rows in
// passes of 128 (a pass compiled for its live slots) take A_ij -= E_i .
// F_j for every column j <= i, E_i in registers, two columns at a time
// (their loads ahead of their stores); last A_iS = F_i, A_SS = -P, u_S =
// F_u.  Four pivots a pass over the triangle: a load and a store of an
// entry serve four FMAs.
//
// Launch geometry: ops/logmvn_kernels.py (chain_grad_geometry) decides it;
// the launchers check only what the kernels' safety needs.

#include <cuda_runtime.h>

#include <cstdint>

// The warp kernel: warps a block, and each row bound it is compiled for
// with its blocks an SM (the launch bound, which caps a thread's
// registers), as ops/logmvn_kernels.py's CHAIN_GRAD_WARPS and
// CHAIN_GRAD_BLOCKS_PER_SM give them.  ops/chain_grad_sweep.py rebuilds this
// file with other values: at row bound 24 (the training's k = 20) four
// blocks of 64 registers, 28 bytes of them spilled, beat three of 80 by a
// quarter, a sample a warp instead of up to two (PERF.md).
#ifndef K3G_WARPS
#define K3G_WARPS 8
#endif
#ifndef K3G_ROWS_AND_BLOCKS
#define K3G_ROWS_AND_BLOCKS 24, 4, 32, 2, 64, 1
#endif

namespace {

constexpr int kWarps = K3G_WARPS;

template <int... V>
struct RowTable {
  // the launch bound of row bound kmax; 0 where kmax is not compiled
  __host__ __device__ static constexpr int blocks(int kmax) {
    const int v[] = {V...};
    for (int i = 0; i + 1 < (int)sizeof...(V); i += 2)
      if (v[i] == kmax) return v[i + 1];
    return 0;
  }
};
using Rows = RowTable<K3G_ROWS_AND_BLOCKS>;

// floats of one column buffer of the warp kernel: a slot a lane and row,
// then u_p, in whole float4s
__host__ __device__ constexpr int col_floats(int kmax) { return 32 * ((kmax + 31) / 32) + 4; }

// offset of column c's segment in the packed triangle of width k
__device__ __forceinline__ int col_off(int c, int k) { return c * k - c * (c - 1) / 2; }

// entry (i, c) of the packed symmetric triangle, on either side of the
// diagonal
__device__ __forceinline__ int tri_at(int i, int c, int k) {
  return i > c ? col_off(c, k) + i - c : col_off(i, k) + c - i;
}

// Stage a sample's packed triangle (kp floats at src) into buf at src's
// offset modulo 16 bytes, the body in 16-byte copies; returns its start.
__device__ __forceinline__ float* stage_triangle(const float* src, float* buf, int kp,
                                                 int lane) {
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* const dst = buf + shift;
  const int head = min(kp, (4 - shift) & 3);
  const int nv = (kp - head) >> 2;
  const int tail = head + 4 * nv;
  if (lane < head) dst[lane] = __ldg(src + lane);
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (int v = lane; v < nv; v += 32) dst4[v] = __ldg(src4 + v);
  if (tail + lane < kp) dst[tail + lane] = __ldg(src + tail + lane);
  return dst;
}

template <int KMAX>
__global__ void __launch_bounds__(32 * kWarps, Rows::blocks(KMAX))
logmvn_chain_grad_kernel(const float* __restrict__ B, const float* __restrict__ u,
                         const float* __restrict__ g, int S, int k, int buf,
                         float* __restrict__ dB, float* __restrict__ du,
                         float* __restrict__ dmisc) {
  constexpr int Q = (KMAX + 31) / 32;  // rows a lane: slot q holds row q * 32 + lane
  constexpr int CB = col_floats(KMAX);
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int a = threadIdx.x & 31;
  float* const cols = reinterpret_cast<float*>(smem4) + warp * buf;  // two column buffers
  float* const tri = cols + 2 * CB;
  const int kp = k * (k + 1) / 2;
  // warp w of the grid's T takes samples w S / T up to (w + 1) S / T
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + warp;
  const int first = (int)(w * S / nwarps);
  const int last = (int)((w + 1) * S / nwarps);

  for (int s = first; s < last; ++s) {
    const float* const T = stage_triangle(B + (size_t)s * kp, tri, kp, a);
    float ru[Q], sig[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int row = q * 32 + a;
      ru[q] = row < k ? __ldg(u + (size_t)s * k + row) : 0.0f;
      sig[q] = 1.0f;
    }
    const float gs = __ldg(g + s);
    __syncwarp();

    // lane a's rows of A = I + B in full, zero past k - 1
    float r[Q][KMAX];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int row = q * 32 + a;
      const bool live = row < k;
      const int upper = live ? col_off(row, k) - row : 0;  // entry (row, j > row) at upper + j
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        float x = 0.0f;
        if (live && j < k) x = T[j <= row ? col_off(j, k) + row - j : upper + j];
        r[q][j] = live && j == row ? x + 1.0f : x;
      }
    }

    bool bad = false;
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p < k) {
        const int qp = p / 32, lp = p % 32;  // lane lp, slot qp holds row p
        float* const cb = cols + (p & 1) * CB;
#pragma unroll
        for (int q = 0; q < Q; ++q) cb[q * 32 + a] = sig[q] * r[q][p];
        if (a == lp) cb[32 * Q] = ru[qp];  // u_p (sig_p is 1 until step p)
        __syncwarp();
        float c[KMAX];
#pragma unroll
        for (int j = 0; j < KMAX; j += 4) {
          const float4 x = *reinterpret_cast<const float4*>(cb + j);
          c[j] = x.x;
          c[j + 1] = x.y;
          c[j + 2] = x.z;
          c[j + 3] = x.w;
        }
        const float cu = cb[32 * Q];
        const float d = c[p];
        bad |= !(d > 0.0f);
        const float inv = __frcp_rn(d);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const bool piv = q == qp && a == lp;
          const float gq = piv ? 0.0f : r[q][p] * inv;
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (j != p) r[q][j] = fmaf(-gq, c[j], r[q][j]);
          ru[q] = fmaf(-gq, cu, ru[q]);
          r[q][p] = piv ? -1.0f : gq;
          if (piv) sig[q] = inv;
        }
      }
    }

    // v = A^-1 u (v_a = sig_a u_a), broadcast through the column buffer
    // the last step did not read
    float v[Q];
    float* const vb = cols + (k & 1) * CB;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      v[q] = sig[q] * ru[q];
      vb[q * 32 + a] = v[q];
    }
    __syncwarp();
    const float nan = __int_as_float(0x7fc00000);
    const float hd = bad ? nan : -0.5f * gs;  // a diagonal entry's factor
    const float ho = bad ? nan : -gs;         // an off-diagonal one's: both halves
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int row = q * 32 + a;
      if (row < k) du[(size_t)s * k + row] = bad ? nan : gs * v[q];
    }
    if (a == 0) {
      dmisc[2 * (size_t)s] = -0.5f * gs;
      dmisc[2 * (size_t)s + 1] = -0.5f * gs;
    }
    // column j of dB: lane i >= j from its entry (i, j) of -A^-1
    float* const out = dB + (size_t)s * kp;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        const float vj = vb[j];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int row = q * 32 + a;
          if (j < (q + 1) * 32 && row >= j && row < k)
            out[col_off(j, k) + row - j] =
                (row == j ? hd : ho) * (v[q] * vj - sig[q] * r[q][j]);
        }
      }
    }
  }
}

template <int KMAX>
int launch(const float* B, const float* u, const float* g, int S, int k, int buf, int smem,
           int grid, float* dB, float* du, float* dmisc, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logmvn_chain_grad_kernel<KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  logmvn_chain_grad_kernel<KMAX><<<grid, 32 * kWarps, smem, stream>>>(B, u, g, S, k, buf, dB,
                                                                     du, dmisc);
  return (int)cudaGetLastError();
}

constexpr int kWideWarps = 8;  // warps a block of the wide kernel in shared memory, at most
constexpr int kWorkWarps = 4;  // warps a block of it in the global workspace
constexpr int kPivots = 4;     // pivots a step of the wide sweep

// floats of a wide warp's buffer: F (a float4 a column, and one for u), u
// in whole float4s, then the triangle with 3 floats of alignment in whole
// float4s
__host__ __device__ inline int wide_floats(int k) {
  return 4 * (k + 1) + 4 * ((k + 3) / 4) + 4 * ((k * (k + 1) / 2 + 3 + 3) / 4);
}

__device__ __forceinline__ float dot_sub(float m, float4 e, float4 f) {
  m = fmaf(-e.x, f.x, m);
  m = fmaf(-e.y, f.y, m);
  m = fmaf(-e.z, f.z, m);
  return fmaf(-e.w, f.w, m);
}

// Columns jb..je-1 of a pass (rows r0 + 32 q + lane, slots M0 <= q < NQ;
// the slots below M0 hold no row >= jb): entry (i, j) -= E_i . F_j for i
// >= j, two columns at a time with both columns' loads ahead of their
// stores.
template <int NQ, int M0>
__device__ __forceinline__ void wide_columns(float* T, const float4* F4, int k,
                                             const float4 (&e)[NQ], int r0, int lane, int jb,
                                             int je) {
  float* col = T + col_off(jb, k) - jb;  // entry (i, j) at col[i]
  int j = jb;
  for (; j + 1 < je; j += 2) {
    float* const col1 = col + k - 1 - j;  // column j + 1
    const float4 f0 = F4[j], f1 = F4[j + 1];
    float m0[NQ], m1[NQ];
#pragma unroll
    for (int q = M0; q < NQ; ++q) {
      const int i = r0 + 32 * q + lane;
      m0[q] = i < k && i >= j ? col[i] : 0.0f;
      m1[q] = i < k && i > j ? col1[i] : 0.0f;
    }
#pragma unroll
    for (int q = M0; q < NQ; ++q) {
      const int i = r0 + 32 * q + lane;
      if (i < k && i >= j) col[i] = dot_sub(m0[q], e[q], f0);
      if (i < k && i > j) col1[i] = dot_sub(m1[q], e[q], f1);
    }
    col = col1 + k - 2 - j;
  }
  if (j < je) {
    const float4 f0 = F4[j];
#pragma unroll
    for (int q = M0; q < NQ; ++q) {
      const int i = r0 + 32 * q + lane;
      if (i < k && i >= j) col[i] = dot_sub(col[i], e[q], f0);
    }
  }
}

// One pass of the update: rows r0 + 32 q + lane, q < NQ (the pass's live
// slots), against every column j <= i; E_i is 0 for the pivot rows and the
// rows past k - 1, F_j for the pivot columns.
template <int NQ>
__device__ __forceinline__ void wide_pass(float* T, const float4* F4, float* U, int k, int p,
                                          int nb, int r0, int lane) {
  float4 e[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = r0 + 32 * q + lane;
    const bool live = i < k && (unsigned)(i - p) >= (unsigned)nb;
    e[q].x = live ? T[tri_at(i, p, k)] : 0.0f;
    e[q].y = live && nb > 1 ? T[tri_at(i, p + 1, k)] : 0.0f;
    e[q].z = live && nb > 2 ? T[tri_at(i, p + 2, k)] : 0.0f;
    e[q].w = live && nb > 3 ? T[tri_at(i, p + 3, k)] : 0.0f;
  }
  const float4 fu = F4[k];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = r0 + 32 * q + lane;
    if (i < k) U[i] = dot_sub(U[i], e[q], fu);
  }
  const int jend = min(k, r0 + 32 * NQ);
  // the columns left of the pass: every slot's rows lie below them
  wide_columns<NQ, 0>(T, F4, k, e, r0, lane, 0, min(r0, jend));
  // the columns of slot m: slots m and up
  wide_columns<NQ, 0>(T, F4, k, e, r0, lane, r0, min(r0 + 32, jend));
  if constexpr (NQ > 1) wide_columns<NQ, 1>(T, F4, k, e, r0, lane, r0 + 32, min(r0 + 64, jend));
  if constexpr (NQ > 2) wide_columns<NQ, 2>(T, F4, k, e, r0, lane, r0 + 64, min(r0 + 96, jend));
  if constexpr (NQ > 3) wide_columns<NQ, 3>(T, F4, k, e, r0, lane, r0 + 96, jend);
}

// kGlobal: each warp's buffer in work (wide_floats(k) floats a warp)
// instead of shared memory
template <bool kGlobal>
__global__ void __launch_bounds__(32 * kWideWarps) logmvn_chain_grad_wide_kernel(
    const float* __restrict__ B, const float* __restrict__ u, const float* __restrict__ g,
    int S, int k, int buf, float* __restrict__ work, float* __restrict__ dB,
    float* __restrict__ du, float* __restrict__ dmisc) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const long long nwarps = (long long)gridDim.x * nw;
  const long long w = (long long)blockIdx.x * nw + warp;
  float* wb;
  if constexpr (kGlobal)
    wb = work + w * buf;
  else
    wb = reinterpret_cast<float*>(smem4) + warp * buf;
  float4* const F4 = reinterpret_cast<float4*>(wb);  // F_j, then F_u at k
  float* const U = wb + 4 * (k + 1);
  float* const tri = U + 4 * ((k + 3) / 4);
  const int kp = k * (k + 1) / 2;
  const int first = (int)(w * S / nwarps);
  const int last = (int)((w + 1) * S / nwarps);

  for (int s = first; s < last; ++s) {
    float* const T = stage_triangle(B + (size_t)s * kp, tri, kp, lane);
    for (int i = lane; i < k; i += 32) U[i] = __ldg(u + (size_t)s * k + i);
    const float gs = __ldg(g + s);
    __syncwarp();
    for (int c = lane; c < k; c += 32) T[col_off(c, k)] += 1.0f;  // + I
    __syncwarp();

    bool bad = false;
    for (int p = 0; p < k; p += kPivots) {
      const int nb = min(kPivots, k - p);
      // the pivot block, I past its nb live pivots, swept in every lane: G
      // = -M_SS^-1 = -P
      float G[kPivots][kPivots];
#pragma unroll
      for (int x = 0; x < kPivots; ++x)
#pragma unroll
        for (int y = 0; y < kPivots; ++y)
          G[x][y] = x < nb && y < nb ? T[tri_at(p + x, p + y, k)] : (x == y ? 1.0f : 0.0f);
#pragma unroll
      for (int t = 0; t < kPivots; ++t) {
        const float d = G[t][t];
        bad |= !(d > 0.0f);
        const float inv = __frcp_rn(d);
        float col[kPivots], f[kPivots];
#pragma unroll
        for (int x = 0; x < kPivots; ++x) {
          col[x] = G[x][t];
          f[x] = col[x] * inv;
        }
#pragma unroll
        for (int x = 0; x < kPivots; ++x)
#pragma unroll
          for (int y = 0; y < kPivots; ++y)
            if (x != t && y != t) G[x][y] = fmaf(-f[x], col[y], G[x][y]);
#pragma unroll
        for (int x = 0; x < kPivots; ++x) {
          if (x != t) {
            G[x][t] = f[x];
            G[t][x] = f[x];
          }
        }
        G[t][t] = -inv;
      }
      // F_j = P E_j for the columns (0 for the pivot columns), F_u = P u_S
      for (int j = lane; j <= k; j += 32) {
        float e[kPivots];
        const bool pivot = (unsigned)(j - p) < (unsigned)nb;
#pragma unroll
        for (int t = 0; t < kPivots; ++t)
          e[t] = t >= nb || pivot ? 0.0f : j == k ? U[p + t] : T[tri_at(j, p + t, k)];
        float f[kPivots];
#pragma unroll
        for (int x = 0; x < kPivots; ++x) {
          f[x] = -G[x][0] * e[0];
#pragma unroll
          for (int y = 1; y < kPivots; ++y) f[x] = fmaf(-G[x][y], e[y], f[x]);
        }
        F4[j] = make_float4(f[0], f[1], f[2], f[3]);
      }
      __syncwarp();
      for (int r0 = 0; r0 < k; r0 += 128) {
        switch ((min(k - r0, 128) + 31) / 32) {  // the pass's live slots
          case 1: wide_pass<1>(T, F4, U, k, p, nb, r0, lane); break;
          case 2: wide_pass<2>(T, F4, U, k, p, nb, r0, lane); break;
          case 3: wide_pass<3>(T, F4, U, k, p, nb, r0, lane); break;
          default: wide_pass<4>(T, F4, U, k, p, nb, r0, lane);
        }
      }
      __syncwarp();
      // A_iS = F_i, A_SS = G, u_S = F_u
      for (int i = lane; i < k; i += 32) {
        if ((unsigned)(i - p) >= (unsigned)nb) {
          const float4 f = F4[i];
          T[tri_at(i, p, k)] = f.x;
          if (nb > 1) T[tri_at(i, p + 1, k)] = f.y;
          if (nb > 2) T[tri_at(i, p + 2, k)] = f.z;
          if (nb > 3) T[tri_at(i, p + 3, k)] = f.w;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int x = 0; x < kPivots; ++x)
#pragma unroll
          for (int y = 0; y <= x; ++y)
            if (x < nb) T[tri_at(p + x, p + y, k)] = G[x][y];
      }
      if (lane < nb) U[p + lane] = reinterpret_cast<const float*>(F4 + k)[lane];
      __syncwarp();
    }

    // the triangle holds -A^-1, U holds v
    const float nan = __int_as_float(0x7fc00000);
    const float hd = bad ? nan : -0.5f * gs;
    const float ho = bad ? nan : -gs;
    for (int i = lane; i < k; i += 32) du[(size_t)s * k + i] = bad ? nan : gs * U[i];
    if (lane == 0) {
      dmisc[2 * (size_t)s] = -0.5f * gs;
      dmisc[2 * (size_t)s + 1] = -0.5f * gs;
    }
    float* out = dB + (size_t)s * kp;
    const float* col = T;
    for (int j = 0; j < k; ++j) {
      const float vj = U[j];
      for (int i = j + lane; i < k; i += 32)
        out[i - j] = (i == j ? hd : ho) * (U[i] * vj - col[i - j]);
      out += k - j;
      col += k - j;
    }
    __syncwarp();  // the buffer is free for the next sample
  }
}

}  // namespace

// The wide kernel's launch (chain_grad_geometry past the row bounds): a
// warp a sample, either 1 to kWideWarps warps with shared bytes of a
// wide_floats buffer a warp (a whole number of float4s a warp) and no
// workspace, or kWorkWarps warps, no shared bytes and a workspace of grid x
// kWorkWarps x wide_floats(k) floats.  Anything else is refused, as is an
// empty grid.
extern "C" int logmvn_chain_grad_wide_launch(const float* B, const float* u, const float* g,
                                             int S, int k, int threads, int smem, int grid,
                                             float* work, float* dB, float* du, float* dmisc,
                                             void* stream) {
  const int warps = threads / 32;
  if (S < 1 || k < 1 || grid < 1 || threads % 32 != 0 || warps < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (work != nullptr) {
    if (warps != kWorkWarps || smem != 0) return (int)cudaErrorInvalidValue;
    logmvn_chain_grad_wide_kernel<true><<<grid, threads, 0, st>>>(B, u, g, S, k, wide_floats(k),
                                                                  work, dB, du, dmisc);
    return (int)cudaGetLastError();
  }
  if (warps > kWideWarps || smem > 227 * 1024 || smem % (16 * warps) != 0 ||
      smem / (4 * warps) < wide_floats(k))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(logmvn_chain_grad_wide_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  logmvn_chain_grad_wide_kernel<false><<<grid, threads, smem, st>>>(
      B, u, g, S, k, smem / (4 * warps), nullptr, dB, du, dmisc);
  return (int)cudaGetLastError();
}

// The geometry (row bound, warps a block, shared bytes, grid) comes from
// chain_grad_geometry.  Refused: a row bound that is not compiled or is
// below k, a block of other than the compiled warps, a warp's share of
// shared memory short of its two column buffers, its triangle and the 3
// floats of alignment, and an empty grid.
extern "C" int logmvn_chain_grad_launch(const float* B, const float* u, const float* g, int S,
                                        int k, int rows, int warps, int smem, int grid,
                                        float* dB, float* du, float* dmisc, void* stream) {
  if (S < 1 || k < 1 || k > rows || Rows::blocks(rows) == 0 || warps != kWarps || grid < 1 ||
      smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int buf = (smem / (4 * warps)) & ~3;  // floats, in whole float4s
  if (buf < 2 * col_floats(rows) + k * (k + 1) / 2 + 3) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case 24: return launch<24>(B, u, g, S, k, buf, smem, grid, dB, du, dmisc, st);
    case 32: return launch<32>(B, u, g, S, k, buf, smem, grid, dB, du, dmisc, st);
    default: return launch<64>(B, u, g, S, k, buf, smem, grid, dB, du, dmisc, st);
  }
}
