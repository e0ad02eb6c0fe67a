// The absorption tail that K5 (csrc/absorption_tail.cu) and K6
// (csrc/absorption_windowed.cu) share: per sample row s and output pixel q,
//   out[s, q] = sum_{k<7} taps[k] * exp(-nhi[s] * tau[s, q + k])   (q < P - 6),
// stored as float32 or as int16 codes, where each kernel's Source gives the
// unit optical depth tau of a run of a row's pixels (K5 reads it, K6 adds
// its window corrections onto the far field).
//
// Bound on the card: device-memory bytes; per pixel an exp and 7 FMAs.
// The earlier design (a 256-thread block a row, the row in shared memory,
// three to five block barriers a row) kept little in flight: each phase
// waited for a whole load round trip, and only 8 rows' loads were in flight
// on an SM.  This one keeps every SM streaming:
//   - a lane owns kPix consecutive pixels (8 shipped: two 16-byte loads),
//     loaded as 16-byte vectors where the row allows it (8-byte or 4-byte
//     loads where it does not: K5's rows of 1,286 floats are 8-byte aligned
//     every other row), so a warp steps through a row kChunk pixels at a
//     time;
//   - the rows' chunks form one sequence, and each warp takes an even run
//     of it (Python's tail_geometry, K3's grid rule: one even wave), row
//     piece by row piece; a piece's last output chunk needs the first 6
//     pixels of the next chunk, its halo item, which only the first lane
//     loads;
//   - each warp keeps kDepth items' loads in flight in registers: the load
//     of item i + kDepth is issued before item i is computed, so a warp's
//     loads overlap its own exps, stencils and stores, and an SM holds
//     warps x kDepth chunks in flight (32 x 2 x 1 KB at the shipped
//     geometry, above Little's ~18 KB an SM at 3 TB/s);
//   - exp(-nhi tau) goes into a per-warp ring of two chunks in shared
//     memory, from which a lane reads its own pixels and the 6 of halo past
//     them (16-byte and 8-byte shared loads), with __syncwarp and no block
//     barrier;
//   - the outputs go out as 16-byte float4 (float32) or 8-byte short4
//     (int16) stores where the output row is aligned for them.
// ops/tail_sweep.py times other geometries: on an H100 (PERF.md)
// 4 pixels a lane with 2 items in flight are as fast for K5 and ~5% slower
// for K6, 1 item in flight 10-40% slower for K6 (its window loads wait on
// the c0 load), and a 40-register bound spills and costs ~10%.
// The stencil sums in the twin's order (ops/voigt_kernels.py
// absorption_tail_reference, PyTorch's instrumental_broadening), contracted
// to FMAs; the exp is expf.  The int16 code is the correctly rounded
// product rounded half to even (as torch.round; roundf would round half away
// from zero).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Pixels a lane, items in flight a warp, warps a block and blocks an SM (the
// launch bound), as ops/voigt_kernels.py's K56_PIXELS, K56_DEPTH,
// K56_WARPS and K56_BLOCKS_PER_SM give them; ops/tail_sweep.py rebuilds
// both kernels at other values.
#ifndef K56_GEOMETRY
#define K56_GEOMETRY 8, 2, 8, 4
#endif

namespace {
namespace stencil {

template <int PIX, int DEPTH, int WARPS, int BLOCKS>
struct GeometryOf {
  static constexpr int kPix = PIX, kDepth = DEPTH, kWarps = WARPS, kBlocks = BLOCKS;
};
using Geometry = GeometryOf<K56_GEOMETRY>;

constexpr int kPix = Geometry::kPix;
constexpr int kDepth = Geometry::kDepth;
constexpr int kWarps = Geometry::kWarps;
constexpr int kChunk = 32 * kPix;  // pixels a warp step
constexpr int kRing = 2 * kChunk;   // floats a warp
constexpr int kTaps = 7;
constexpr int kHalo = kTaps - 1;
constexpr float kI16Scale = 32767.0f;  // ABS_I16_SCALE
static_assert(kPix == 4 || kPix == 8, "a lane's pixels are one or two float4");
static_assert(kDepth >= 1 && kDepth <= 4, "items in flight a warp");

// v[i] = p[i] for i < n, 0 beyond: one run of N floats, as float4, float2
// or float loads by p's alignment (the same for every lane of a warp).
template <int N>
__device__ __forceinline__ void load_run(const float* __restrict__ p, int n, float (&v)[N]) {
  if (n >= N) {
    const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p)) & 15u;
    if (a == 0) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p) + j);
        v[4 * j] = t.x, v[4 * j + 1] = t.y, v[4 * j + 2] = t.z, v[4 * j + 3] = t.w;
      }
    } else if (a == 8) {
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p) + j);
        v[2 * j] = t.x, v[2 * j + 1] = t.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = __ldg(p + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = i < n ? __ldg(p + i) : 0.0f;
  }
}

__device__ __forceinline__ int16_t encode_i16(float a) {
  return static_cast<int16_t>(__float2int_rn(__fmul_rn(a, kI16Scale)));
}

// The first m of N outputs at o: 16-byte float4 stores where o is aligned
// for them and all N are inside the row, else one store a pixel.
template <int N>
__device__ __forceinline__ void store_run(float* o, int m, const float (&v)[N]) {
  if (m >= N && !(reinterpret_cast<uintptr_t>(o) & 15u)) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      reinterpret_cast<float4*>(o)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < m) o[i] = v[i];
  }
}

// int16 codes: 8-byte short4 stores where o is aligned for them.
template <int N>
__device__ __forceinline__ void store_run(int16_t* o, int m, const float (&v)[N]) {
  if (m >= N && !(reinterpret_cast<uintptr_t>(o) & 7u)) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      reinterpret_cast<short4*>(o)[j] =
          make_short4(encode_i16(v[4 * j]), encode_i16(v[4 * j + 1]),
                      encode_i16(v[4 * j + 2]), encode_i16(v[4 * j + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < m) o[i] = encode_i16(v[i]);
  }
}

// A warp's walk over its items.  Item (s, c) holds the kChunk pixels of
// row s from c * kChunk; a halo item only the first kHalo of them.  A run
// of output chunks [k0, k1) in the rows' sequence walks, per row piece
// (s, c0 .. c1 - 1), the full items (s, c0) .. (s, c1 - 1) and then the
// halo item (s, c1).
struct Cursor {
  int s, c;
  int left;   // output chunks of the run whose full item lies ahead
  bool halo;  // this is a piece's halo item
  int nc;     // output chunks a row

  __device__ __forceinline__ void next() {
    if (halo) {
      ++s, c = 0, halo = false;
    } else {
      --left, ++c;
      halo = left == 0 || c == nc;
    }
  }
};

template <class Source, typename OutT>
__global__ void __launch_bounds__(32 * kWarps, Geometry::kBlocks)
tail_kernel(Source src, const float* __restrict__ nhi, const float* __restrict__ taps, int S,
            int P, OutT* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  float* const ring = reinterpret_cast<float*>(smem4) + (threadIdx.x >> 5) * kRing;
  const int n_out = P - kHalo;
  const int nc = (n_out + kChunk - 1) / kChunk;
  // the rows' output chunks in one sequence, row by row: warp w of the
  // grid's T takes chunks w C / T up to (w + 1) C / T
  const long long chunks = (long long)S * nc;  // < 2^31 (checked)
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long wg = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int k0 = (int)(wg * chunks / nwarps), k1 = (int)((wg + 1) * chunks / nwarps);
  if (k0 >= k1) return;
  // every output chunk's full item, and a halo item a row piece
  const int n_items = (k1 - k0) + ((k1 - 1) / nc - k0 / nc + 1);
  float tp[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) tp[k] = __ldg(taps + k);

  // this lane's pixels of an item, with the row's nhi
  auto load = [&](const Cursor& it, float (&v)[kPix], float& nh) {
    const int p0 = it.c * kChunk + kPix * lane;
    const int n = min(P - p0, (it.halo ? kHalo : kChunk) - kPix * lane);
    src.load(it.s, p0, n, v);
    nh = __ldg(nhi + it.s);
  };

  Cursor ahead{k0 / nc, k0 - (k0 / nc) * nc, k1 - k0, false, nc};
  Cursor at = ahead;
  float raw[kDepth][kPix], nhs[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (d < n_items) {
      load(ahead, raw[d], nhs[d]);
      ahead.next();
    }
  }

  bool first = true;  // the item opens a row piece: no output chunk is ready
  for (int i = 0; i < n_items; ++i) {
    float v[kPix];
    const float nh = nhs[0];
#pragma unroll
    for (int j = 0; j < kPix; ++j) v[j] = raw[0][j];
#pragma unroll
    for (int d = 0; d + 1 < kDepth; ++d) {
#pragma unroll
      for (int j = 0; j < kPix; ++j) raw[d][j] = raw[d + 1][j];
      nhs[d] = nhs[d + 1];
    }
    if (i + kDepth < n_items) {
      load(ahead, raw[kDepth - 1], nhs[kDepth - 1]);
      ahead.next();
    }

    float* slot = ring + (i & 1) * kChunk + kPix * lane;
#pragma unroll
    for (int j = 0; j < kPix / 4; ++j)
      reinterpret_cast<float4*>(slot)[j] =
          make_float4(expf(-nh * v[4 * j]), expf(-nh * v[4 * j + 1]),
                      expf(-nh * v[4 * j + 2]), expf(-nh * v[4 * j + 3]));
    __syncwarp();
    if (!first) {
      // output chunk c - 1 of row s: the previous item's slot and this one's
      const int a = ((i - 1) & 1) * kChunk + kPix * lane;
      float r[kPix + kHalo];
#pragma unroll
      for (int j = 0; j <= kPix / 4; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(ring + ((a + 4 * j) & (kRing - 1)));
        r[4 * j] = t.x, r[4 * j + 1] = t.y, r[4 * j + 2] = t.z, r[4 * j + 3] = t.w;
      }
      const float2 t = *reinterpret_cast<const float2*>(ring + ((a + kPix + 4) & (kRing - 1)));
      r[kPix + 4] = t.x, r[kPix + 5] = t.y;
      float o[kPix];
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        float acc = tp[0] * r[q];
#pragma unroll
        for (int k = 1; k < kTaps; ++k) acc = acc + tp[k] * r[q + k];
        o[q] = acc;
      }
      const int q0 = (at.c - 1) * kChunk + kPix * lane;
      store_run(out + (size_t)at.s * n_out + q0, n_out - q0, o);
    }
    __syncwarp();  // the next item overwrites the previous item's slot
    first = at.halo;
    at.next();
  }
}

// Refused: a problem the kernel cannot index (S < 1, P <= 6, S x chunks a
// row >= 2^31), a block of other than the compiled warps, other shared
// memory than the warps' rings, an empty grid, another store.
inline int check_launch(int S, int P, int store, int warps, int smem, int grid) {
  if (S < 1 || P <= kHalo || store < 0 || store > 1) return (int)cudaErrorInvalidValue;
  const long long nc = (P - kHalo + kChunk - 1) / kChunk;
  if ((long long)S * nc >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (warps != kWarps || smem != kWarps * kRing * (int)sizeof(float) || grid < 1)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// store 0 writes float32, 1 int16 codes.
template <class Source>
int launch(const Source& src, const float* nhi, const float* taps, int S, int P, int store,
           int warps, int smem, int grid, void* out, cudaStream_t stream) {
  const int bad = check_launch(S, P, store, warps, smem, grid);
  if (bad) return bad;
  if (store) {
    tail_kernel<Source, int16_t><<<grid, 32 * kWarps, smem, stream>>>(
        src, nhi, taps, S, P, static_cast<int16_t*>(out));
  } else {
    tail_kernel<Source, float><<<grid, 32 * kWarps, smem, stream>>>(
        src, nhi, taps, S, P, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace stencil
}  // namespace
