// zqso_cap: the zQSO exact scan's in-window Woodbury inputs for a chunk of
// C candidate redshifts, straight from the learned table and the padded
// spectrum; K3 (logmvn_chain) finishes the likelihood.
//
// No TPU kernel: the JAX package's exact scan is plain XLA
// (gpy_dla_detection_tpu/models/zqso.py, z_log_evidences), which forms the
// model interpolated onto every pixel at every z, (C, P, k), and runs the
// dense Woodbury on it; its answer to the gathers was the shift scan, which
// the port leaves out.  This kernel never writes that basis.
//
// Per redshift z and pixel p it evaluates what models/zqso's composition
// (interp_uniform + log_mvnpdf_low_rank) evaluates, rounding every product
// and sum as the composition rounds it (no contraction into FMAs):
//   rest = wl / (1 + z) (float64); the pixel is in the window where
//   min_lambda <= rest <= max_lambda, min_obs < wl < max_obs and it is
//   valid;  rest_q = float(rest), t = (rest_q - x0) / dx, idx = clamp(floor
//   t, 0, R - 2), f = clamp(t - idx, 0, 1);  m_i = M[idx, i] (1 - f) +
//   M[idx + 1, i] f, mu likewise;  y = flux / med, v = noise / med^2,
//   delta = y - mu, d_inv = 1 / v;
// and per z, over the pixels in the window,
//   B[a, j] = sum m_a (m_j d_inv)  (j <= a: K3's packed lower triangle,
//   column-major),  u[a] = sum m_a (d_inv delta),
//   misc = (sum (delta delta) d_inv, sum log v + n log 2 pi).
// The sums are the only difference from the composition: FMAs in their
// own order, where the library's SGEMM has its own.
//
// Bound on the card: the products, 2 (k(k+1)/2 + k) operations a (z, pixel
// in the window): 19 GFLOP a scan of 10,000 z on a linear 0.8 A grid of
// 5,600 pixels (~4,150 in the window on average, k = 20), 0.29 ms at 67
// TFLOP/s.
//
// Design.  A block takes a run of Z_B consecutive redshifts (a lane each)
// over a tile of pixels, in sub-tiles of kSub pixels.  Neighbouring
// redshifts read neighbouring rows of the table (a step of the grid moves a
// pixel by ~0.6 rows), so a sub-tile's rows, a band of ~100-150 at the
// main path's grid, are staged in shared memory once for all its z:
//   1. every thread evaluates the pixel terms of (z, pixel) pairs of the
//      sub-tile (the float64 division, the window, idx and f, mu, delta,
//      d_inv) into a table of (idx, f, d_inv, d_inv delta), sums misc's
//      terms in registers, and the block takes the band's first and last
//      row (order-free integer min and max); the sub-tile's pixels were
//      staged in shared memory during the last one.  A z whose median is
//      +-inf (no pixel in its normalization window) takes its quotients
//      from their IEEE special values, since a division by 0 or inf leaves
//      IEEE division's fast path;
//   2. the band's rows, up to its last, go to shared memory (rows of k
//      floats padded to a stride whose float4s fall in distinct banks for 8
//      consecutive rows; float4 copies where k is a multiple of 4);
//   3. each warp takes a piece of the output for its 32 redshifts: the
//      rows [A0, A1) of the packed triangle and of u, at most kPieceCap
//      accumulators a thread in registers (k <= 20: rows 0-13 and 14-19,
//      119 and 111 accumulators).  A pixel costs the thread the
//      interpolation of its piece's rows and of the columns below them
//      (float4 loads of the two table rows), one product m_j d_inv a
//      column, and an FMA an accumulator.
// A band wider than kBandRows (a coarse grid of z, unsorted wavelengths)
// is taken in windows of kBandRows rows, each pixel in the window that
// holds its two rows.  The pieces of a block run different code a warp and
// the same barriers.
//
// Partial sums.  Each block writes its tile's partial sums, one writer an
// entry, to a workspace laid out [tile][entry][z] (lanes on consecutive z:
// coalesced); a second kernel sums the tiles in order.  A scan repeats bit
// for bit.
//
// On an H100 at 10,000 z, P = 5,632, k = 20: 1.39 ms, 19.5% of the bound
// (PERF.md); without the accumulation 0.50 ms.  ptxas: 168
// registers a thread at the launch bound of 3 blocks an SM, ~100 bytes of
// spills, which beat 2 blocks an SM without them (ops/zqso_cap_sweep.py).
//
// Launch geometry: ops/logmvn_kernels.py (zqso_cap_geometry) decides the
// tile; the launcher refuses any block but the compiled one.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// Pixels a sub-tile, blocks an SM at row bounds 20 and 32 (the launch
// bounds, which cap a thread's registers), as ops/logmvn_kernels.py's
// ZQSO_CAP_SUB and ZQSO_CAP_BLOCKS_PER_SM give them; and the ablation
// stage (0: the kernel; 1: without the accumulation).
// ops/zqso_cap_sweep.py rebuilds this file with other values.
#ifndef ZQSO_CAP_SUB
#define ZQSO_CAP_SUB 32
#endif
#ifndef ZQSO_CAP_BLOCKS
#define ZQSO_CAP_BLOCKS 3, 2
#endif
#ifndef ZQSO_CAP_ABLATE
#define ZQSO_CAP_ABLATE 0
#endif

namespace {

constexpr int kSub = ZQSO_CAP_SUB;  // pixels a sub-tile
constexpr int kBandRows = 256;      // table rows a band window holds
constexpr int kPieceCap = 120;      // accumulators a thread's piece holds at most
constexpr int kBlocks[2] = {ZQSO_CAP_BLOCKS};
constexpr float kLog2Pi = 1.8378770664093453f;

// the triangle's rows split into pieces of at most kPieceCap accumulators
// (row a: a + 1 entries of B and one of u); piece g is rows [lo[g], lo[g + 1])
struct Pieces {
  int n;
  int lo[33];
};

constexpr Pieces pieces_of(int kmax) {
  Pieces p{0, {}};
  int a = 0;
  while (a < kmax) {
    int held = 0;
    int b = a;
    while (b < kmax && (held + b + 2 <= kPieceCap || b == a)) {
      held += b + 2;
      ++b;
    }
    p.n += 1;
    p.lo[p.n] = b;
    a = b;
  }
  return p;
}

template <int KMAX>
struct Geometry {
  static constexpr Pieces kPieces = pieces_of(KMAX);
  static constexpr int pieces = kPieces.n;
  static constexpr int zwarps = pieces == 1 ? 4 : pieces == 2 ? 2 : 1;  // warps of z a piece
  static constexpr int zs = 32 * zwarps;  // redshifts a block
  static constexpr int threads = zs * pieces;
  static constexpr int blocks = kBlocks[KMAX <= 20 ? 0 : 1];  // blocks an SM (launch bound)
  static constexpr int stride = KMAX % 8 == 4 ? KMAX : KMAX + 4;  // floats a band row
  static constexpr int pairs = (kSub + pieces - 1) / pieces;  // pixel terms a thread a sub-tile
  // the terms, the band, two sub-tiles' pixels (wl; flux, noise, valid) and
  // the band's bounds
  static constexpr int shared_bytes =
      kSub * zs * 16 + kBandRows * stride * 4 + 2 * kSub * (8 + 3 * 4) + 16;
};

struct alignas(16) Term {
  int row;     // idx, the table row below the pixel's rest wavelength; < 0 out of the window
  float f;     // the interpolation weight of row idx + 1
  float dinv;  // 1 / v
  float wd;    // d_inv delta
};

struct Inputs {
  const double* z;
  const float* med;
  const double* lo_obs;
  const double* hi_obs;
  int C;
  const double* wl;
  const float* flux;
  const float* noise;
  const unsigned char* valid;
  int P;
  const float* rest_wl;
  const float* mu;
  const float* M;
  int R;
  int k;
  double min_lambda;
  double max_lambda;
};

__device__ __forceinline__ float lerp_rn(float lo, float hi, float omf, float f) {
  return __fadd_rn(__fmul_rn(lo, omf), __fmul_rn(hi, f));
}

// rows [A0, A1) of the triangle and of u for one redshift, in registers
template <int S, int A0, int A1>
struct Piece {
  static constexpr int NR = A1 - A0;
  static constexpr int NC = (A1 + 3) / 4;  // float4 columns the piece reads
  float acc[NR][A1];
  float uacc[NR];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int a = A0; a < A1; ++a) {
#pragma unroll
      for (int j = 0; j <= a; ++j) acc[a - A0][j] = 0.0f;
      uacc[a - A0] = 0.0f;
    }
  }

  // one pixel: its rows lo (idx) and lo + S (idx + 1) of the band
  __device__ __forceinline__ void add(const float* lo, float f, float dinv, float wd) {
    const float omf = __fsub_rn(1.0f, f);
    float m[NR];
#pragma unroll
    for (int c = A0 / 4; c < NC; ++c) {
      const float4 l = *reinterpret_cast<const float4*>(lo + 4 * c);
      const float4 h = *reinterpret_cast<const float4*>(lo + S + 4 * c);
      const float lv[4] = {l.x, l.y, l.z, l.w};
      const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = 4 * c + q;
        if (a >= A0 && a < A1) m[a - A0] = lerp_rn(lv[q], hv[q], omf, f);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float mc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (4 * c < A0) {  // columns below the piece: interpolated here
        const float4 l = *reinterpret_cast<const float4*>(lo + 4 * c);
        const float4 h = *reinterpret_cast<const float4*>(lo + S + 4 * c);
        mc[0] = lerp_rn(l.x, h.x, omf, f);
        mc[1] = lerp_rn(l.y, h.y, omf, f);
        mc[2] = lerp_rn(l.z, h.z, omf, f);
        mc[3] = lerp_rn(l.w, h.w, omf, f);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 4 * c + q;
        if (j < A1) {
          const float dm = __fmul_rn(j >= A0 ? m[j - A0] : mc[q], dinv);
#pragma unroll
          for (int a = (j > A0 ? j : A0); a < A1; ++a)
            acc[a - A0][j] = fmaf(m[a - A0], dm, acc[a - A0][j]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NR; ++a) uacc[a] = fmaf(m[a], wd, uacc[a]);
  }

  // the partial sums, at [entry][z] of the tile's part: entry (a, j) of the
  // packed triangle at j k - j (j - 1) / 2 + a - j, u's a at kp + a
  __device__ __forceinline__ void store(float* part, int C, int z, int k) const {
    const int kp = k * (k + 1) / 2;
#pragma unroll
    for (int a = A0; a < A1; ++a) {
      if (a < k) {
#pragma unroll
        for (int j = 0; j <= a; ++j)
          part[(size_t)(j * k - j * (j - 1) / 2 + a - j) * C + z] = acc[a - A0][j];
        part[(size_t)(kp + a) * C + z] = uacc[a - A0];
      }
    }
  }
};

// the whole tile for a warp of piece [A0, A1)
template <int KMAX, int A0, int A1>
__device__ __forceinline__ void run_tile(const Inputs& in, int tile_pixels, float* part) {
  using G = Geometry<KMAX>;
  extern __shared__ float4 smem4[];
  Term* const terms = reinterpret_cast<Term*>(smem4);  // [kSub][zs]
  float* const band = reinterpret_cast<float*>(terms + kSub * G::zs);  // [kBandRows][stride]
  double* const px_wl = reinterpret_cast<double*>(band + kBandRows * G::stride);  // [2][kSub]
  float* const px_flux = reinterpret_cast<float*>(px_wl + 2 * kSub);
  float* const px_noise = px_flux + 2 * kSub;
  int* const px_ok = reinterpret_cast<int*>(px_noise + 2 * kSub);
  int* const bounds = px_ok + 2 * kSub;  // [2][first, last]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = in.C, P = in.P, R = in.R, k = in.k;
  const int z0 = blockIdx.x * G::zs;
  const int p_begin = blockIdx.y * tile_pixels;
  const int p_end = min(P, p_begin + tile_pixels);
  const bool vec4 = (k & 3) == 0 && (reinterpret_cast<uintptr_t>(in.M) & 15) == 0;

  // the pixel terms: redshift zl1 of the block, pixels s1, s1 + pieces, ...
  const int zl1 = tid % G::zs;
  const int s1 = tid / G::zs;
  const int zi1 = z0 + zl1;
  const bool live1 = zi1 < C;
  double opz = 1.0, lo_obs = 0.0, hi_obs = 0.0;
  float med = 1.0f, med2 = 1.0f;
  if (live1) {
    opz = 1.0 + in.z[zi1];
    lo_obs = in.lo_obs[zi1];
    hi_obs = in.hi_obs[zi1];
    med = in.med[zi1];
    med2 = __fmul_rn(med, med);
  }
  // a median of +-inf (no pixel in the normalization window) would send
  // every division of its z down the slow path of IEEE division: its
  // quotients are taken from their special values instead
  const bool med_inf = isinf(med);
  const float rmed = copysignf(0.0f, med);  // 1 / med where med_inf
  const float x0 = __ldg(in.rest_wl);
  const float dx = __fsub_rn(__ldg(in.rest_wl + 1), x0);
  float quad = 0.0f, logd = 0.0f, cnt = 0.0f;

  // the accumulation: redshift zl2 of the block, piece [A0, A1)
  const int zl2 = (warp % G::zwarps) * 32 + lane;
  Piece<G::stride, A0, A1> piece;
  piece.zero();

  // a sub-tile's pixels, loaded a sub-tile ahead by the first kSub threads
  auto load_pixels = [&](int sub, int buf) {
    if (tid < kSub) {
      const int p = sub + tid;
      const bool ok = p < p_end;
      px_wl[buf * kSub + tid] = ok ? __ldg(in.wl + p) : 1.0;
      px_flux[buf * kSub + tid] = ok ? __ldg(in.flux + p) : 0.0f;
      px_noise[buf * kSub + tid] = ok ? __ldg(in.noise + p) : 1.0f;
      px_ok[buf * kSub + tid] = ok && in.valid[p] ? 1 : 0;
    }
  };
  load_pixels(p_begin, 0);
  if (tid < 4) bounds[tid] = (tid & 1) ? INT_MIN : INT_MAX;
  __syncthreads();

  int slot = 0;
  for (int sub = p_begin; sub < p_end; sub += kSub, slot ^= 1) {
    int first = INT_MAX, last = INT_MIN;
#pragma unroll 2
    for (int i = 0; i < G::pairs; ++i) {
      const int q = s1 + i * G::pieces;
      if (G::pairs * G::pieces != kSub && q >= kSub) break;
      const int b = slot * kSub + q;
      const double wl = px_wl[b];
      const double rest = wl / opz;
      Term t{-1, 0.0f, 0.0f, 0.0f};
      if (live1 && px_ok[b] && rest >= in.min_lambda && rest <= in.max_lambda &&
          wl > lo_obs && wl < hi_obs) {
        const float tq = __fdiv_rn(__fsub_rn(__double2float_rn(rest), x0), dx);
        const int idx = min(max((int)floorf(tq), 0), R - 2);
        const float f = fminf(fmaxf(__fsub_rn(tq, (float)idx), 0.0f), 1.0f);
        const float mu = lerp_rn(__ldg(in.mu + idx), __ldg(in.mu + idx + 1),
                                 __fsub_rn(1.0f, f), f);
        float y, v, dinv;
        if (med_inf) {  // an empty normalization window: the quotients' IEEE values
          y = __fmul_rn(px_flux[b], rmed);      // flux / +-inf
          v = __fmul_rn(px_noise[b], 0.0f);     // noise / +inf
          dinv = v != v ? v : copysignf(INFINITY, v);  // 1 / +-0
        } else {
          y = __fdiv_rn(px_flux[b], med);
          v = __fdiv_rn(px_noise[b], med2);
          dinv = __fdiv_rn(1.0f, v);
        }
        const float delta = __fsub_rn(y, mu);
        t = Term{idx, f, dinv, __fmul_rn(dinv, delta)};
        quad += __fmul_rn(__fmul_rn(delta, delta), dinv);
        logd += logf(v);
        cnt += 1.0f;
        first = min(first, idx);
        last = max(last, idx);
      }
      terms[q * G::zs + zl1] = t;
    }
    if (sub + kSub < p_end) load_pixels(sub + kSub, slot ^ 1);
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) {
      if (first != INT_MAX) atomicMin(bounds + 2 * slot, first);
      if (last != INT_MIN) atomicMax(bounds + 2 * slot + 1, last);
    }
    __syncthreads();
    const int band_first = bounds[2 * slot];
    const int band_last = bounds[2 * slot + 1];
    if (tid == 0) {  // the other slot, read before the last sub-tile's final barrier
      bounds[2 * (slot ^ 1)] = INT_MAX;
      bounds[2 * (slot ^ 1) + 1] = INT_MIN;
    }
    if (band_first > band_last) {
      __syncthreads();
      continue;
    }
    for (int w0 = band_first; w0 <= band_last; w0 += kBandRows - 1) {
      const int rows = min(min(kBandRows, R - w0), band_last + 2 - w0);
      if (vec4) {  // rows of whole, aligned float4s
        constexpr int S4 = G::stride / 4;
        const float4* M4 = reinterpret_cast<const float4*>(in.M) + (size_t)w0 * (k / 4);
        for (int e = tid; e < rows * S4; e += G::threads) {
          const int r = e / S4;
          const int c = e - r * S4;
          reinterpret_cast<float4*>(band)[e] =
              4 * c < k ? __ldg(M4 + r * (k / 4) + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      } else {
        for (int e = tid; e < rows * G::stride; e += G::threads) {
          const int r = e / G::stride;
          const int c = e - r * G::stride;
          band[e] = c < k ? __ldg(in.M + (size_t)(w0 + r) * k + c) : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int q = 0; q < (ZQSO_CAP_ABLATE == 1 ? 0 : kSub); ++q) {
        const Term t = terms[q * G::zs + zl2];
        const int r = t.row - w0;
        if ((unsigned)r < (unsigned)(kBandRows - 1))
          piece.add(band + r * G::stride, t.f, t.dinv, t.wd);
      }
      __syncthreads();
    }
  }

  const int zi2 = z0 + zl2;
  float* const tile_part = part + (size_t)blockIdx.y * (k * (k + 1) / 2 + k + 3) * C;
  if (zi2 < C) piece.store(tile_part, C, zi2, k);

  // misc's partial sums: the pieces' threads of a redshift, in order
  float* const scratch = reinterpret_cast<float*>(smem4);
  scratch[(0 * G::pieces + s1) * G::zs + zl1] = quad;
  scratch[(1 * G::pieces + s1) * G::zs + zl1] = logd;
  scratch[(2 * G::pieces + s1) * G::zs + zl1] = cnt;
  __syncthreads();
  if (s1 == 0 && live1) {
    const int kp = k * (k + 1) / 2;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = 0.0f;
      for (int g = 0; g < G::pieces; ++g) s += scratch[(i * G::pieces + g) * G::zs + zl1];
      tile_part[(size_t)(kp + k + i) * C + zi1] = s;
    }
  }
}

template <int KMAX, int G0>
__device__ __forceinline__ void dispatch(int g, const Inputs& in, int tile_pixels, float* part) {
  if constexpr (G0 < Geometry<KMAX>::pieces) {
    if (g == G0) {
      run_tile<KMAX, Geometry<KMAX>::kPieces.lo[G0], Geometry<KMAX>::kPieces.lo[G0 + 1]>(
          in, tile_pixels, part);
    } else {
      dispatch<KMAX, G0 + 1>(g, in, tile_pixels, part);
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(Geometry<KMAX>::threads, Geometry<KMAX>::blocks)
zqso_cap_kernel(Inputs in, int tile_pixels, float* __restrict__ part) {
  // warp w takes piece w / zwarps (a warp-uniform branch)
  dispatch<KMAX, 0>((threadIdx.x >> 5) / Geometry<KMAX>::zwarps, in, tile_pixels, part);
}

// the tiles' partial sums in order: B, u and misc = (quad0, logdet0 + n log 2 pi)
__global__ void zqso_cap_sum_kernel(const float* __restrict__ part, int tiles, int C, int k,
                                    float* __restrict__ B, float* __restrict__ u,
                                    float* __restrict__ misc) {
  const int kp = k * (k + 1) / 2;
  const int nout = kp + k + 3;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(nout - 1) * C) return;
  const int z = (int)(i % C);
  const int e = (int)(i / C);
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t) s += part[((size_t)t * nout + e) * C + z];
  if (e < kp) {
    B[(size_t)z * kp + e] = s;
  } else if (e < kp + k) {
    u[(size_t)z * k + e - kp] = s;
  } else if (e == kp + k) {
    misc[2 * (size_t)z] = s;
  } else {
    float n = 0.0f;
    for (int t = 0; t < tiles; ++t) n += part[((size_t)t * nout + e + 1) * C + z];
    misc[2 * (size_t)z + 1] = __fadd_rn(s, __fmul_rn(n, kLog2Pi));
  }
}

template <int KMAX>
int launch(const Inputs& in, int tile_pixels, int tiles, int threads, int smem, float* part,
           float* B, float* u, float* misc, cudaStream_t stream) {
  using G = Geometry<KMAX>;
  if (threads != G::threads || smem != G::shared_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(zqso_cap_kernel<KMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((in.C + G::zs - 1) / G::zs, tiles);
  zqso_cap_kernel<KMAX><<<grid, threads, smem, stream>>>(in, tile_pixels, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)(in.k * (in.k + 1) / 2 + in.k + 2) * in.C;
  zqso_cap_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, tiles, in.C, in.k,
                                                                     B, u, misc);
  return (int)cudaGetLastError();
}

}  // namespace

// The geometry (row bound, pixels a tile, tiles, threads, shared bytes)
// comes from zqso_cap_geometry.  Refused: a row bound that is not compiled
// or is below k, a table of fewer than 2 rows, tiles that are not whole
// sub-tiles or do not cover the P pixels, and a block of other than the
// compiled threads and shared bytes.
extern "C" int zqso_cap_launch(const double* z, const float* med, const double* lo_obs,
                               const double* hi_obs, int C, const double* wl, const float* flux,
                               const float* noise, const unsigned char* valid, int P,
                               const float* rest_wl, const float* mu, const float* M, int R,
                               int k, double min_lambda, double max_lambda, int kmax,
                               int tile_pixels, int tiles, int threads, int smem, float* part,
                               float* B, float* u, float* misc, void* stream) {
  if (C < 1 || P < 1 || R < 2 || k < 1 || k > kmax || tile_pixels < kSub ||
      tile_pixels % kSub != 0 || tiles != (P + tile_pixels - 1) / tile_pixels ||
      tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const Inputs in{z, med, lo_obs, hi_obs, C, wl, flux, noise, valid, P,
                  rest_wl, mu, M, R, k, min_lambda, max_lambda};
  cudaStream_t st = (cudaStream_t)stream;
  if (kmax == 20) return launch<20>(in, tile_pixels, tiles, threads, smem, part, B, u, misc, st);
  if (kmax == 32) return launch<32>(in, tile_pixels, tiles, threads, smem, part, B, u, misc, st);
  return (int)cudaErrorInvalidValue;
}
