// K2's block: the staging, the elementwise assembly and the capacitance
// products of the batched Woodbury log-likelihood, for one block of TS
// samples, ended by an epilogue the caller chooses.  K2 (logmvn_cap.cu)
// stores B, u and misc; K7's stage kernel (logmvn_ablate.cu) stops after
// the assembly, sums the products, or runs K3's warp chain on them.  One
// header, so the ablation measures the block K2 ships.
//
// Per sample s, over the N pixels:
//   a     = A[s] * prod(extra streams)        (masked pixels: a = 1)
//   d     = omega2 a^2 + v,  d_inv = mask / d (guarded: masked -> 0)
//   delta = mask ? y - mu a : 0
//   w = a^2 d_inv,   r = a delta d_inv
// and, where the epilogue wants products, B[s, :] = w @ basis columns, u[s,
// :] = r @ M, with quad0 = sum delta^2 d_inv and logdet0 = -sum log d_inv.
//
// Design.  A thread owns an 8-sample x 8-column register tile (64
// accumulators); a warp is 2 sample groups x 16 column groups, and a block
// TS samples x all columns, padded to whole warps (ncp columns).  The
// launch geometry (TS, the pixel chunk TN, threads, shared bytes, grid) is
// chosen in Python (ops/logmvn_kernels.py: cap_geometry) and checked by
// each launcher.  At S = 10,000, N = 1,280, k = 20 packed it is TS = 80,
// TN = 32, 320 threads (10 warps, 2 x 16 padded column groups = 256
// columns), 125 blocks: one wave on 132 SMs, one block per SM; 134,144
// shared bytes with no extra stream, 210,944 with three.
//
// A basis wider than one block holds (k > 53 packed at N = 1,280) goes
// to K2's wide kernel (logmvn_cap_wide.cu), on the tensor cores.
//
// The pixels are walked in chunks of TN with one barrier a chunk.  The raw
// sample tile (A and the extra streams) is staged by cp.async two chunks
// ahead and the M_pair | M chunk one chunk ahead (a column a thread, down
// the chunk), each double-buffered.  In iteration c every thread assembles
// w and r of chunk c + 1 (into the other half of a double-buffered w | r
// tile), then runs chunk c's FMAs, loading the next pixel's operands before
// the current pixel's FMAs (the 384-thread bound leaves it the registers).
//
// The assembly maps a warp onto 4 samples x 8 pixels and walks a fixed set
// of sample quads (at most 4), so each thread keeps quad0 and logdet0 of
// its samples in double registers; the 8 pixel lanes of a sample are summed
// with warp shuffles at the end.  Within a quad it is branch-free: a pixel
// past N reads as masked (m = 0), which makes its w, r and both terms
// exactly 0.  The valid-pixel count is counted once per block.  Shared
// layouts: the staged tile rows are TN + 8 floats long and the w | r rows
// TS + 4, so the assembly's reads and writes fall in 32 distinct banks; the
// M chunk keeps columns 0-3 and 4-7 of every group in two halves, so the
// FMA loop's LDS.128 reads of a warp's 16 column groups are 256 contiguous
// bytes, and its w or r reads 2 distinct 16-byte words.  Threads past the
// last column group (padding) load, assemble and sum like the others and
// store nothing.
//
// Compact storage (the reference's GPY_DLA_ABS_DTYPE=i16 / i16p: the
// _decode in _assemble).  A and the streams may arrive as int16 codes
// round(a * 32767), all of one launch alike; an instantiation of its own
// stages the codes as they are, in half the shared bytes (16 bytes are 8
// codes; rows of TN + 8 codes keep the assembly's reads in distinct
// banks), and decodes them in the assembly, code * (1 / 32767) rounded
// once (__fmul_rn, so no FMA takes the product in), ahead of the same
// float32 arithmetic: fed the same codes decoded to float32, the float32
// instantiation computes the same values.  A row is staged 16 bytes a
// copy where N % 8 == 0, 4 bytes (2 codes) where N is even, and by plain
// loads and stores where N is odd (cp.async moves 4, 8 or 16 bytes, and
// an odd-N row of codes need not be 4-byte aligned); the plain stores go
// to the buffer no thread reads until the next barrier.  Rows past S
// stage as zeros (a = 0) in every instantiation; their accumulators and
// sums are their own and never stored.
//
// The epilogue (Epi) is a struct of the outputs with
//   kProducts  stage the basis and run the FMA loop (else: staging and
//              assembly only; the w | r tile is still written);
//   kLogDet    the assembly sums log d_inv (else d_inv itself, no logf);
//   kSumWR     the assembly also sums w + r per sample;
//   finish(block, acc, q, ld, wr)  after the last chunk, with every thread
//              past the block's last barrier (shared memory is free), the
//              pixel lanes' sums reduced and the valid pixels counted.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cap_block {

constexpr int kTile = 8;          // samples and columns of a thread's tile
constexpr int kWarpSG = 2;        // sample groups of a warp
constexpr int kWarpCG = 16;       // column groups of a warp
constexpr int kMaxThreads = 384;  // 168 registers a thread
constexpr int kMaxQuads = 4;      // sample quads one warp assembles
constexpr float kLog2Pi = 1.8378770664093453f;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// padded columns: whole warps of column groups over the two products
__host__ __device__ inline int padded_columns(int k, int kp) {
  return kTile * kWarpCG * cdiv(cdiv(kp, kTile) + cdiv(k, kTile), kWarpCG);
}

// elem: bytes of a staged sample-stream element (4 float32, 2 int16 codes)
inline size_t shared_bytes(int ts, int tn, int ncp, int n_extra, int elem) {
  return (size_t)elem * 2 * (1 + n_extra) * ts * (tn + 8) +
         sizeof(float) * ((size_t)2 * tn * ncp + (size_t)4 * tn * (ts + 4));
}

// warps of a block of ts samples over ncp padded columns
__host__ __device__ inline int block_warps(int ts, int ncp) {
  return (ts / (kTile * kWarpSG)) * (ncp / (kTile * kWarpCG));
}

// The geometry a launcher takes: TS whole warps of sample groups, a chunk
// of 16 or 32 pixels, the threads of the block's warps within the bound,
// cap_geometry's shared bytes, a block for every TS samples.
inline bool geometry_ok(int S, int k, int kp, int n_extra, int elem, int ts, int tn,
                        int threads, int smem, int grid) {
  const int ncp = padded_columns(k, kp);
  return ts >= kTile * kWarpSG && ts % (kTile * kWarpSG) == 0 && (tn == 16 || tn == 32) &&
         threads == 32 * block_warps(ts, ncp) && threads <= kMaxThreads &&
         (size_t)smem == shared_bytes(ts, tn, ncp, n_extra, elem) && grid == cdiv(S, ts);
}

__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ inline void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// a staged element as float32: float32 as it is, an int16 code decoded
constexpr float kInvI16Scale = 1.0f / 32767.0f;  // 1 / ABS_I16_SCALE
__device__ __forceinline__ float decode(float x) { return x; }
__device__ __forceinline__ float decode(int16_t code) {
  return __fmul_rn(static_cast<float>(code), kInvI16Scale);
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// What an epilogue needs of the block: its place and its thread's roles.
struct Block {
  float* smem;    // the block's shared memory, free for the epilogue
  int s0;         // first sample of the block
  int TS, S, k, kp;
  int gp;         // column groups of the pair basis
  int cg, sg;     // this thread's column group and sample group
  int warp, nwarps, wc;  // wc: warps across the columns
  int sl_lo, nl_lo;      // the assembly's sample and pixel lane
  int n_quads;
  int n_valid;    // valid pixels
};

// T: the sample streams' storage (float, or int16_t codes).  VB: the bytes
// of a staging copy, 16 (rows a whole number of 16-byte groups, aligned) or
// 4 by cp.async, or 0: plain loads and stores (int16 codes of odd N)
template <int TN, int VB, typename T, class Epi>
__device__ __forceinline__ void run(
    const float* __restrict__ rows, int N, const float* __restrict__ M, int k,
    const float* __restrict__ Mp, int kp, const T* __restrict__ A,
    const T* __restrict__ e0, const T* __restrict__ e1,
    const T* __restrict__ e2, int n_extra, int S, int TS, const Epi& epi) {
  constexpr int TNP = TN + 8;  // staged row length (bank spread)
  const int TSP = TS + 4;      // w | r row length (4 x odd: bank spread)
  const int gp = cdiv(kp, kTile);
  const int ncp = padded_columns(k, kp);
  const int half = ncp / 2;
  const int n_streams = 1 + n_extra;
  const int n_chunks = cdiv(N, TN);
  const int n_quads = TS / 4;
  const int stream_stride = TS * TNP;

  extern __shared__ float4 smem4[];
  T* As = reinterpret_cast<T*>(smem4);  // [2][streams][TS][TNP]
  // [2][TN][ncp] (halves); 16-byte aligned, TS being a multiple of 16
  float* Mc = reinterpret_cast<float*>(As + 2 * n_streams * stream_stride);
  float* WR = Mc + 2 * TN * ncp;  // [2][w | r][TN][TSP]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int wc = ncp / (kTile * kWarpCG);  // warps across the columns
  const int cg = (warp % wc) * kWarpCG + lane % kWarpCG;
  const int sg = (warp / wc) * kWarpSG + lane / kWarpCG;
  const int s0 = blockIdx.x * TS;
  const int nl_lo = lane & 7;  // the assembly's 4 samples x 8 pixels
  const int sl_lo = lane >> 3;

  auto stage_samples = [&](int c, int buf) {
    const int n0 = c * TN;
    for (int st = 0; st < n_streams; ++st) {
      const T* src = st == 0 ? A : st == 1 ? e0 : st == 2 ? e1 : e2;
      T* dst = As + (buf * n_streams + st) * stream_stride;
      if constexpr (VB > 0) {
        constexpr int V = VB / sizeof(T);  // elements a copy
        for (int e = tid; e < TS * (TN / V); e += nthreads) {
          const int sl = e / (TN / V);
          const int j = e % (TN / V);
          const int s = s0 + sl;
          const int n = n0 + V * j;
          const bool ok = s < S && n < N;
          const T* from = ok ? src + (size_t)s * N + n : src;
          if constexpr (VB == 16) {
            cp_async16(dst + sl * TNP + V * j, from, ok ? 16 : 0);
          } else {
            cp_async4(dst + sl * TNP + V * j, from, ok ? 4 : 0);
          }
        }
      } else {
        for (int e = tid; e < TS * TN; e += nthreads) {
          const int sl = e / TN;
          const int nl = e % TN;
          const int s = s0 + sl;
          const int n = n0 + nl;
          dst[sl * TNP + nl] = s < S && n < N ? src[(size_t)s * N + n] : T(0);
        }
      }
    }
  };

  // a padded column a thread, down the chunk's pixels; a warp's lanes
  // read neighbouring columns of a row
  auto stage_basis = [&](int c, int buf) {
    const int n0 = c * TN;
    float* dst = Mc + buf * TN * ncp;
    for (int col = tid; col < ncp; col += nthreads) {
      const int g = col / kTile;
      const int j = col % kTile;
      const float* src = nullptr;
      int stride = 0;
      if (g < gp) {
        if (col < kp) {
          src = Mp + col;
          stride = kp;
        }
      } else if (col - gp * kTile < k) {
        src = M + (col - gp * kTile);
        stride = k;
      }
      float* d = dst + (j >> 2) * half + g * 4 + (j & 3);
#pragma unroll 4
      for (int nl = 0; nl < TN; ++nl) {
        const int n = n0 + nl;
        const bool ok = src != nullptr && n < N;
        cp_async4(d + nl * ncp, ok ? src + (size_t)n * stride : M, ok ? 4 : 0);
      }
    }
  };

  double q_acc[kMaxQuads], ld_acc[kMaxQuads], wr_acc[kMaxQuads];
#pragma unroll
  for (int qi = 0; qi < kMaxQuads; ++qi) q_acc[qi] = ld_acc[qi] = wr_acc[qi] = 0.0;
  float acc[kTile][kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.0f;

  // chunk 0's tile and basis, chunk 1's tile
  stage_samples(0, 0);
  if constexpr (Epi::kProducts) stage_basis(0, 0);
  if (n_chunks > 1) stage_samples(1, 1);
  cp_async_commit();
  cp_async_wait_all();

  // iteration c: stage chunk c + 2's tile and chunk c + 1's basis,
  // assemble chunk c + 1's w | r, run chunk c's FMAs (c = -1: assemble only)
  for (int c = -1; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int next = (c + 1) & 1;
    // chunk c's w | r and basis and chunk c + 1's tile are in; chunk
    // c - 1's readers are done
    __syncthreads();
    if (c >= 0) {
      if (c + 2 < n_chunks) stage_samples(c + 2, buf);
      if constexpr (Epi::kProducts)
        if (c + 1 < n_chunks) stage_basis(c + 1, next);
      cp_async_commit();
    }

    if (c + 1 < n_chunks) {
      const int n0 = (c + 1) * TN;
      const T* as = As + next * n_streams * stream_stride;
      float* W = WR + next * 2 * TN * TSP;
      float* R = W + TN * TSP;
#pragma unroll
      for (int qi = 0; qi < kMaxQuads; ++qi) {
        const int quad = warp + qi * nwarps;
        if (quad < n_quads) {
          const int sl = 4 * quad + sl_lo;
          double qs = 0.0, lds = 0.0, wrs = 0.0;
#pragma unroll
          for (int oc = 0; oc < TN / 8; ++oc) {
            const int nl = oc * 8 + nl_lo;
            const int n = n0 + nl;
            const bool in = n < N;
            const int nc = in ? n : N - 1;
            const float yv = __ldg(rows + nc);
            const float muv = __ldg(rows + N + nc);
            const float om = __ldg(rows + 2 * N + nc);
            const float vv = __ldg(rows + 3 * N + nc);
            const float m = in ? __ldg(rows + 4 * N + nc) : 0.0f;
            const bool valid = m > 0.0f;
            const T* ap = as + sl * TNP + nl;
            float a_raw = decode(ap[0]);
            if (n_extra > 0) a_raw = a_raw * decode(ap[stream_stride]);
            if (n_extra > 1) a_raw = a_raw * decode(ap[2 * stream_stride]);
            if (n_extra > 2) a_raw = a_raw * decode(ap[3 * stream_stride]);
            const float a = valid ? a_raw : 1.0f;
            const float d = om * a * a + vv;
            const float d_inv = m / (valid ? d : 1.0f);
            const float delta = valid ? yv - muv * a : 0.0f;
            const float w = a * a * d_inv;
            const float r = a * delta * d_inv;
            W[nl * TSP + sl] = w;
            R[nl * TSP + sl] = r;
            qs += (double)(delta * delta * d_inv);
            if constexpr (Epi::kLogDet)
              lds += (double)logf(d_inv + (valid ? 0.0f : 1.0f));
            else
              lds += (double)d_inv;
            if constexpr (Epi::kSumWR) wrs += (double)(w + r);
          }
          q_acc[qi] += qs;
          ld_acc[qi] += lds;
          if constexpr (Epi::kSumWR) wr_acc[qi] += wrs;
        }
      }
    }
    if constexpr (Epi::kProducts) {
      if (c >= 0) {
        const float* Wc = WR + buf * 2 * TN * TSP;
        const float* L = (cg < gp ? Wc : Wc + TN * TSP) + sg * kTile;
        const float* Mb = Mc + buf * TN * ncp + cg * 4;
        float4 l0 = *reinterpret_cast<const float4*>(L);
        float4 l1 = *reinterpret_cast<const float4*>(L + 4);
        float4 c0 = *reinterpret_cast<const float4*>(Mb);
        float4 c1 = *reinterpret_cast<const float4*>(Mb + half);
#pragma unroll
        for (int nl = 0; nl < TN; ++nl) {
          float4 p0 = l0, p1 = l1, q0 = c0, q1 = c1;
          if (nl + 1 < TN) {
            p0 = *reinterpret_cast<const float4*>(L + (nl + 1) * TSP);
            p1 = *reinterpret_cast<const float4*>(L + (nl + 1) * TSP + 4);
            q0 = *reinterpret_cast<const float4*>(Mb + (nl + 1) * ncp);
            q1 = *reinterpret_cast<const float4*>(Mb + (nl + 1) * ncp + half);
          }
          const float ls[kTile] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
          const float cs[kTile] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int i = 0; i < kTile; ++i)
#pragma unroll
            for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(ls[i], cs[j], acc[i][j]);
          l0 = p0;
          l1 = p1;
          c0 = q0;
          c1 = q1;
        }
      }
    }
    if (c >= 0) cp_async_wait_all();
  }

  // quad0 and logdet0 (and sum w + r): the 8 pixel lanes of each sample
#pragma unroll
  for (int qi = 0; qi < kMaxQuads; ++qi) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      q_acc[qi] += __shfl_xor_sync(0xffffffffu, q_acc[qi], off);
      ld_acc[qi] += __shfl_xor_sync(0xffffffffu, ld_acc[qi], off);
      if constexpr (Epi::kSumWR) wr_acc[qi] += __shfl_xor_sync(0xffffffffu, wr_acc[qi], off);
    }
  }
  // a barrier too: every thread is past the loop, so shared memory is free
  int n_valid = 0;
  for (int n0 = 0; n0 < N; n0 += nthreads) {
    const int n = n0 + tid;
    n_valid += __syncthreads_count(n < N && rows[4 * N + n] > 0.0f);
  }
  const Block b{reinterpret_cast<float*>(smem4), s0, TS, S, k, kp, gp, cg, sg, warp,
                nwarps, wc, sl_lo, nl_lo, n_quads, n_valid};
  epi.finish(b, acc, q_acc, ld_acc, wr_acc);
}

}  // namespace cap_block
