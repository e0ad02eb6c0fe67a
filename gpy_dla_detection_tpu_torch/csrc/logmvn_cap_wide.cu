// K2 for GP bases wider than one block of K2's own holds (k > 53 packed at
// N = 1,280): stage A of the batched Woodbury log-likelihood on the tensor
// cores, in 3xTF32.
//
// Replaces: gpy_dla_detection_tpu/ops/logmvn_pallas.py : _make_cap_kernel
// (body _assemble), the first pallas_call of batched_log_mvnpdf_pallas,
// whose _block_s shrinks the sample block under its VMEM budget for such a
// basis.  Same function as logmvn_cap.cu (whose block takes k <= 53):
//   a = A[s] * prod(extra streams) (masked pixels: a = 1), d = omega2 a^2
//   + v, d_inv = mask / d, delta = mask ? y - mu a : 0, w = a^2 d_inv, r =
//   a delta d_inv;  B[s, :] = w @ M_pair (packed or flat),  u[s, :] = r @
//   M,  misc[s] = (sum delta^2 d_inv, -sum log d_inv + n log 2 pi).
//
// Bound on the card: the products, 2 S N (kp + k) operations (39.4 GFLOP at
// S = 10,000, N = 1,280, k = 54).  In IEEE float32 FMAs that is 0.59 ms at
// 67 TFLOP/s; in 3xTF32 (three TF32 products a term) 0.24 ms at 495.
//
// Design.  An output tile is BM = 64 samples x BN = 256 columns of B | u
// (against 128 x 128 it assembles each chunk's w and r for half as many
// column tiles and reads the streams half as often, for twice the basis
// reads: ~1.8 / ~2.3 ms against ~2.0 / ~2.7 at k = 54 / 65 on an H100,
// ops/cap_wide_sweep.py).  The wrapper lays the
// basis out as P = [M_pair | 0 | M | 0], N rows of whole tiles: the pair
// basis padded to whole warps (kpp, a multiple of 32), then the k columns
// of M, so each warp's 32 columns take one operand, w or r, and a chunk of
// the basis is staged in 16-byte copies.  16 warps, 2 x 8, each 32 samples
// x 32 columns: 2 x 4 mma.sync.m16n8k8 TF32 tiles, 32 float32
// accumulators a thread.  Each operand x is split into hi = tf32(x) and lo
// = tf32(x - hi) (round to nearest, cvt.rna), and each 16-pixel chunk sums
// lo.hi + hi.lo + hi.hi (the small products first) on the tensor cores
// into a fresh sum, which is then added to the thread's running sum in
// IEEE float32: the tensor cores truncate the sums they accumulate, and N /
// 8 steps of that in one accumulator bias B low by ~2e-7 of |ll| (the
// likelihood fell outside the reference's float32 budget).  So the product
// keeps float32's accuracy, where one TF32 product keeps ~2^-11
// (tests/test_torch_tf32_split.py).
//
// The pixels are walked in chunks of BK = 16.  Chunk c's sample streams
// (A, the extra streams and the chunk's 5 spectrum rows) and basis go
// through a ring of kStages = 3 stages of cp.async; iteration c issues
// chunk c + 3's streams and chunk c + 2's basis and waits, at its end, on
// the group issued one iteration earlier, never on its own: a copy has two
// iterations to land (a ring of 5, four iterations, was no faster:
// ops/cap_wide_sweep.py).  In iteration c the block assembles chunk c + 1's w
// and r (as the reference's _assemble) from the staged streams into a
// double-buffered tile, already split into hi and lo, in two halves
// between the two 8-pixel steps of chunk c's products (a warp's ALU work
// and its mma interleave): one barrier a chunk.  The assembly is
// branch-free: absent streams multiply by 1, and d_inv = m rcp(d), the
// reciprocal rcp.approx refined by a Newton step (within an ulp of the
// division, whose slow path is a branch an element).  The sums quad0 and
// logdet0 (double, then float, as K2's block) and the valid-pixel count are
// taken only by the blocks of the first column tile, an instantiation of
// the assembly of its own, which store misc.
//
// Grid: one block an output tile, the column tiles of a sample tile
// consecutive (blockIdx.x = sample tile x tiles + column tile), so a
// sample tile's streams, read once by each of its column tiles, stay in L2
// while they are read.  int16 profile codes are staged as they are and
// decoded in the assembly (code * (1 / 32767), rounded once), as K2's
// block does; a row is staged 16 bytes a copy where that is aligned, 4
// bytes where N is even, and by plain loads where N is odd (codes only).
//
// Shared layout (floats first): the basis ring [3][BK][BN + 8], the
// assembled tile [2][w_hi, w_lo, r_hi, r_lo][BK][BM + 8] (pixel-major: a
// fragment's 8 samples x 4 pixels fall in 32 banks), the ring of the
// chunk's 5 spectrum rows [3][5][BK] (staged with its streams: read from
// global memory they came from L2, L1 being mostly shared memory), then the
// stream ring [3][streams][BM][BK + 16 / elem] (a warp's 8 samples x 4
// pixels of assembly reads in distinct banks).  The geometry
// (ops/logmvn_kernels.py: wide_cap_geometry) is checked by the launcher;
// ops/cap_wide_sweep.py times the kernel with each stage left out.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// the tile: samples x padded columns (ops/cap_wide_sweep.py rebuilds this
// file at another)
#ifndef CAP_WIDE_BM
#define CAP_WIDE_BM 64
#endif
#ifndef CAP_WIDE_BN
#define CAP_WIDE_BN 256
#endif
constexpr int kBM = CAP_WIDE_BM;  // samples a tile
constexpr int kBN = CAP_WIDE_BN;  // padded columns a tile
constexpr int kBK = 16;           // pixels a chunk
constexpr int kWarps = 16;
constexpr int kWarpsM = kBM / 32;
constexpr int kWarpsN = kWarps / kWarpsM;
constexpr int kThreads = 32 * kWarps;
constexpr int kWM = kBM / kWarpsM;  // 32 samples a warp
constexpr int kWN = kBN / kWarpsN;  // 32 columns a warp
static_assert(kWM == 32 && kWN == 32, "a warp's tile is 32 x 32");
constexpr int kGroups = kBM / 8;                    // sample groups of 8
constexpr int kQuads = kBM * kBK / (32 * kWarps);   // pixel quads a thread assembles
constexpr int kMT = kWM / 16;       // m16 tiles a warp
constexpr int kNT = kWN / 8;        // n8 tiles a warp
#ifndef CAP_WIDE_STAGES
#define CAP_WIDE_STAGES 3
#endif
constexpr int kStages = CAP_WIDE_STAGES;  // the ring: chunks in flight + 1
static_assert(kStages >= 3, "a copy has at least two iterations to land");
constexpr int kTP = kBM + 8;  // assembled rows (a pixel's samples)
constexpr int kCP = kBN + 8;  // basis rows (a pixel's columns)
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr float kInvI16Scale = 1.0f / 32767.0f;  // 1 / ABS_I16_SCALE

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// staged stream row: 20 floats or 24 codes (16-byte rows, bank spread)
template <typename T>
__host__ __device__ constexpr int raw_row() {
  return kBK + 16 / (int)sizeof(T);
}

__host__ __device__ inline int pair_padded(int kp) { return kWN * cdiv(kp, kWN); }
__host__ __device__ inline int column_tiles(int k, int kp) { return cdiv(pair_padded(kp) + k, kBN); }

inline size_t shared_bytes(int n_extra, int elem) {
  const int rp = kBK + 16 / elem;
  return sizeof(float) * ((size_t)kStages * kBK * kCP + (size_t)2 * 4 * kBK * kTP +
                          (size_t)kStages * 5 * kBK) +
         (size_t)elem * kStages * (1 + n_extra) * kBM * rp;
}

__device__ __forceinline__ float decode(float x) { return x; }
__device__ __forceinline__ float decode(int16_t code) {
  return __fmul_rn(static_cast<float>(code), kInvI16Scale);
}

// 1 / x to within an ulp, without the division's branch to its slow path
__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b, a fresh sum (C = 0)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// every group but the kStages - 2 newest has landed
__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// ops/cap_wide_sweep.py rebuilds this file with one stage left out (1 the
// stream copies, 2 the basis copies, 3 the assembly, 4 the products) to time
// the rest; the shipped build leaves none out
#ifndef CAP_WIDE_ABLATE
#define CAP_WIDE_ABLATE 0
#endif
constexpr bool kStageStreams = CAP_WIDE_ABLATE != 1;
constexpr bool kStageBasis = CAP_WIDE_ABLATE != 2;
constexpr bool kAssemble = CAP_WIDE_ABLATE != 3;
constexpr bool kProducts = CAP_WIDE_ABLATE != 4;

// T: the streams' storage (float, or int16_t codes); VB: the bytes of a
// staging copy (16, 4, or 0: plain loads)
template <int VB, typename T>
__global__ void __launch_bounds__(kThreads, 1) logmvn_cap_wide_kernel(
    const float* __restrict__ rows, int N, const float* __restrict__ P, int k, int kp,
    const T* __restrict__ A, const T* __restrict__ e0, const T* __restrict__ e1,
    const T* __restrict__ e2, int n_extra, int S, float* __restrict__ B,
    float* __restrict__ u, float* __restrict__ misc) {
  constexpr int RP = raw_row<T>();
  const int kpp = pair_padded(kp);
  const int tiles = column_tiles(k, kp);
  const int ncols = tiles * kBN;  // P's row
  const int s0 = (blockIdx.x / tiles) * kBM;
  const int col0 = (blockIdx.x % tiles) * kBN;
  const bool first = col0 == 0;  // sums quad0, logdet0 and stores misc
  const int n_streams = 1 + n_extra;
  const int n_chunks = cdiv(N, kBK);

  extern __shared__ float4 smem4[];
  float* const Bs = reinterpret_cast<float*>(smem4);  // [kStages][kBK][kCP]
  float* const WR = Bs + kStages * kBK * kCP;         // [2][4][kBK][kTP]
  float* const Ys = WR + 2 * 4 * kBK * kTP;           // [kStages][5][kBK]
  T* const Rs = reinterpret_cast<T*>(Ys + kStages * 5 * kBK);  // [kStages][streams][kBM][RP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // fragment group
  const int tg = lane & 3;   // thread in group
  const int wm0 = (warp / kWarpsN) * kWM;
  const int wc0 = col0 + (warp % kWarpsN) * kWN;  // the warp's first padded column
  const bool warp_r = wc0 >= kpp;                  // its operand: r, else w
  const bool warp_live = wc0 < kpp + k && (warp_r || wc0 < kp) && s0 + wm0 < S;

  // the streams and the chunk's 5 rows (y, mu, omega2, v, mask; zeros past
  // N, which read as masked)
  auto stage_streams = [&](int c, int slot) {
    const int n0 = c * kBK;
    if (tid < 5 * kBK) {
      const int n = n0 + tid % kBK;
      const float* src = rows + (size_t)(tid / kBK) * N + n;
      cp_async4(Ys + slot * 5 * kBK + tid, n < N ? src : rows, n < N ? 4 : 0);
    }
    for (int st = 0; st < n_streams; ++st) {
      const T* src = st == 0 ? A : st == 1 ? e0 : st == 2 ? e1 : e2;
      T* dst = Rs + (slot * n_streams + st) * kBM * RP;
      if constexpr (VB > 0) {
        constexpr int V = VB / sizeof(T);  // elements a copy
        for (int e = tid; e < kBM * (kBK / V); e += kThreads) {
          const int sl = e / (kBK / V);
          const int j = e % (kBK / V);
          const int s = s0 + sl;
          const int n = n0 + V * j;
          const bool ok = s < S && n < N;
          const T* from = ok ? src + (size_t)s * N + n : src;
          if constexpr (VB == 16) {
            cp_async16(dst + sl * RP + V * j, from, ok ? 16 : 0);
          } else {
            cp_async4(dst + sl * RP + V * j, from, ok ? 4 : 0);
          }
        }
      } else {
        for (int e = tid; e < kBM * kBK; e += kThreads) {
          const int sl = e / kBK;
          const int nl = e % kBK;
          const int s = s0 + sl;
          const int n = n0 + nl;
          dst[sl * RP + nl] = s < S && n < N ? src[(size_t)s * N + n] : T(0);
        }
      }
    }
  };

  // the tile's 128 columns of P, 16 bytes a copy: a warp on 4 pixels
  auto stage_basis = [&](int c, int slot) {
    const int n0 = c * kBK;
    float* dst = Bs + slot * kBK * kCP;
    for (int e = tid; e < kBK * (kBN / 4); e += kThreads) {
      const int nl = e / (kBN / 4);
      const int v = e % (kBN / 4);
      const int n = n0 + nl;
      const float* src = P + (size_t)n * ncols + col0 + 4 * v;
      cp_async16(dst + nl * kCP + 4 * v, n < N ? src : P, n < N ? 16 : 0);
    }
  };

  // the assembly: a warp on 8 samples x 4 pixels at a time, a thread on one
  // sample (group warp % kGroups) and kQuads of its chunk's 4 pixel quads,
  // quads (warp + kWarps i) / kGroups, half of them a call
  const int a_sl = 8 * (warp % kGroups) + (lane >> 2);
  const int a_pl = lane & 3;  // + 4 q
  const int o1 = (n_extra > 0 ? 1 : 0) * kBM * RP;  // absent streams read
  const int o2 = (n_extra > 1 ? 2 : 0) * kBM * RP;  // stream 0 and multiply
  const int o3 = (n_extra > 2 ? 3 : 0) * kBM * RP;  // by 1
  double q_acc = 0.0, ld_acc = 0.0;

  auto assemble = [&](int slot, int buf, int i0, auto with_sums) {
    const T* ap0 = Rs + slot * n_streams * kBM * RP + a_sl * RP;
    const float* ys = Ys + slot * 5 * kBK;
    float* const Wh = WR + buf * 4 * kBK * kTP + a_sl;
    float* const Wl = Wh + kBK * kTP;
    float* const Rh = Wl + kBK * kTP;
    float* const Rl = Rh + kBK * kTP;
#pragma unroll
    for (int i = i0; i < i0 + kQuads / 2; ++i) {
      const int nl = 4 * ((warp + kWarps * i) / kGroups) + a_pl;
      const float yv = ys[nl];
      const float muv = ys[kBK + nl];
      const float om = ys[2 * kBK + nl];
      const float vv = ys[3 * kBK + nl];
      const float m = ys[4 * kBK + nl];
      const bool valid = m > 0.0f;
      const T* ap = ap0 + nl;
      float a_raw = decode(ap[0]);
      const float x1 = decode(ap[o1]), x2 = decode(ap[o2]), x3 = decode(ap[o3]);
      a_raw = n_extra > 0 ? a_raw * x1 : a_raw;
      a_raw = n_extra > 1 ? a_raw * x2 : a_raw;
      a_raw = n_extra > 2 ? a_raw * x3 : a_raw;
      const float a = valid ? a_raw : 1.0f;
      const float d = om * a * a + vv;
      const float d_inv = m * rcp(valid ? d : 1.0f);
      const float delta = valid ? yv - muv * a : 0.0f;
      const float w = a * a * d_inv;
      const float r = a * delta * d_inv;
      const uint32_t wh = tf32(w), rh = tf32(r);
      Wh[nl * kTP] = __uint_as_float(wh);
      Wl[nl * kTP] = __uint_as_float(tf32(w - __uint_as_float(wh)));
      Rh[nl * kTP] = __uint_as_float(rh);
      Rl[nl * kTP] = __uint_as_float(tf32(r - __uint_as_float(rh)));
      if constexpr (decltype(with_sums)::value) {
        q_acc += (double)(delta * delta * d_inv);
        ld_acc += (double)logf(d_inv + (valid ? 0.0f : 1.0f));
      }
    }
  };
  auto assemble_half = [&](int slot, int buf, int half) {
    if (first)
      assemble(slot, buf, half * kQuads / 2, std::true_type{});
    else
      assemble(slot, buf, half * kQuads / 2, std::false_type{});
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[i][j][x] = 0.0f;
  float t[kMT][kNT][4];  // the chunk's fresh sum

  // one 8-pixel step of a chunk's products: each of the three products
  // over the warp's 8 tiles before the next, so 8 independent mma are in
  // flight between dependent ones; the chunk's first step starts the fresh
  // sum t (C = 0), its second adds t to acc in IEEE float32
  auto products = [&](int slot, int buf, int k8) {
    const float* Bc = Bs + slot * kBK * kCP + (wc0 - col0) + g;
    const float* Ah = WR + (buf * 4 + (warp_r ? 2 : 0)) * kBK * kTP + wm0 + g;
    const float* Al = Ah + kBK * kTP;
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float x = Bc[(k8 + tg + 4 * h) * kCP + 8 * j];
        bh[j][h] = tf32(x);
        bl[j][h] = tf32(x - __uint_as_float(bh[j][h]));
      }
    uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int o0 = (k8 + tg) * kTP + 16 * i;
      const int o4 = o0 + 4 * kTP;
      const int o[4] = {o0, o0 + 8, o4, o4 + 8};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ah[i][r] = __float_as_uint(Ah[o[r]]);
        al[i][r] = __float_as_uint(Al[o[r]]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (k8 == 0)
          mma_tf32_first(t[i][j], al[i], bh[j]);
        else
          mma_tf32(t[i][j], al[i], bh[j]);
      }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(t[i][j], ah[i], bl[j]);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(t[i][j], ah[i], bh[j]);
    if (k8 == kBK - 8) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[i][j][x] += t[i][j][x];
    }
  };

  // iteration c issues chunk c + kStages's streams and chunk c + kStages -
  // 1's basis, one commit group; iterations -kStages to -2 only issue (the
  // ring's prologue)
  auto issue = [&](int c) {
    if (kStageStreams && c + kStages >= 0 && c + kStages < n_chunks)
      stage_streams(c + kStages, (c + kStages) % kStages);
    if (kStageBasis && c + kStages - 1 >= 0 && c + kStages - 1 < n_chunks)
      stage_basis(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
  };
  for (int c = -kStages; c < -1; ++c) issue(c);
  cp_async_wait_older();

  // iteration c: assemble chunk c + 1 in two halves around chunk c's two
  // product steps (c = -1: assemble only)
  for (int c = -1; c < n_chunks; ++c) {
    // chunk c + 1's streams and chunk c's basis have landed; iteration c -
    // 1's readers are done with the slots written now
    __syncthreads();
    issue(c);
    const bool asm_next = kAssemble && c + 1 < n_chunks;
    const bool mul_this = kProducts && c >= 0 && warp_live;
    if (asm_next) assemble_half((c + 1) % kStages, (c + 1) & 1, 0);
    if (mul_this) products(c % kStages, c & 1, 0);
    if (asm_next) assemble_half((c + 1) % kStages, (c + 1) & 1, 1);
    if (mul_this) products(c % kStages, c & 1, 8);
    cp_async_wait_older();
  }

  if (first) {
    // quad0 and logdet0: the 4 pixel lanes of each sample, then its warps
    // (w, w + kGroups, ...) in order, through shared memory
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      q_acc += __shfl_xor_sync(0xffffffffu, q_acc, off);
      ld_acc += __shfl_xor_sync(0xffffffffu, ld_acc, off);
    }
    int n_valid = 0;  // its barriers also free shared memory
    for (int n0 = 0; n0 < N; n0 += kThreads) {
      const int n = n0 + tid;
      n_valid += __syncthreads_count(n < N && rows[4 * N + n] > 0.0f);
    }
    double* const part = reinterpret_cast<double*>(smem4);  // [kWarps][8][2]
    if (a_pl == 0) {
      part[2 * (8 * warp + (lane >> 2))] = q_acc;
      part[2 * (8 * warp + (lane >> 2)) + 1] = ld_acc;
    }
    __syncthreads();
    const int s = s0 + a_sl;
    if (warp < kGroups && a_pl == 0 && s < S) {
      double q = 0.0, ld = 0.0;
#pragma unroll
      for (int w = warp; w < kWarps; w += kGroups) {
        q += part[2 * (8 * w + (lane >> 2))];
        ld += part[2 * (8 * w + (lane >> 2)) + 1];
      }
      misc[2 * (size_t)s] = (float)q;
      misc[2 * (size_t)s + 1] = (float)(-ld) + (float)n_valid * kLog2Pi;
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + wm0 + 16 * i + g + 8 * h;
      if (s >= S) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int c = wc0 + 8 * j + 2 * tg + x;
          const float v = acc[i][j][2 * h + x];
          if (!warp_r) {
            if (c < kp) B[(size_t)s * kp + c] = v;
          } else if (c - kpp < k) {
            u[(size_t)s * k + (c - kpp)] = v;
          }
        }
    }
}

template <typename T>
void* pick(int vb) {
  return vb == 16 ? reinterpret_cast<void*>(logmvn_cap_wide_kernel<16, T>)
         : vb == 4 ? reinterpret_cast<void*>(logmvn_cap_wide_kernel<4, T>)
                   : reinterpret_cast<void*>(logmvn_cap_wide_kernel<0, T>);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// P: the basis laid out as wide_cap_basis lays it, [M_pair | 0 | M | 0],
// N rows of tiles x 128 floats, 16-byte aligned.  store: A and the streams
// as float32 (0) or int16 codes (1).  The geometry (samples a tile, pixels
// a chunk, padded pair columns, column tiles, threads, shared bytes, grid)
// must be the one wide_cap_geometry gives for (S, k, kp, n_extra) and the
// store's element size; anything else is refused, as is a float32 stream
// not 4-byte aligned.
extern "C" int logmvn_cap_wide_launch(
    const float* rows, int N, const float* P, int k, int kp, const void* A, const void* e0,
    const void* e1, const void* e2, int n_extra, int store, int S, int ts, int tn, int kpp,
    int tiles, int threads, int smem, int grid, float* B, float* u, float* misc,
    void* stream) {
  if (k < 1 || kp < 1 || N < 1 || S < 1 || n_extra < 0 || n_extra > 3 ||
      (store != 0 && store != 1) || !aligned(P, 16))
    return (int)cudaErrorInvalidValue;
  const int elem = store ? 2 : 4;
  if (ts != kBM || tn != kBK || kpp != pair_padded(kp) || tiles != column_tiles(k, kp) ||
      threads != kThreads || (size_t)smem != shared_bytes(n_extra, elem) ||
      smem > 227 * 1024 || (long long)grid != (long long)cdiv(S, kBM) * tiles)
    return (int)cudaErrorInvalidValue;
  const void* ps[4] = {A, e0, e1, e2};
  bool a16 = true, a4 = true;
  for (int i = 0; i <= n_extra; ++i) {
    a16 = a16 && aligned(ps[i], 16);
    a4 = a4 && aligned(ps[i], 4);
  }
  const int vb = (N * elem) % 16 == 0 && a16 ? 16 : (N * elem) % 4 == 0 && a4 ? 4 : 0;
  if (store == 0 && vb == 0) return (int)cudaErrorInvalidValue;
  void* kern = store ? pick<int16_t>(vb) : pick<float>(vb);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&rows, &N, &P, &k, &kp, &A, &e0, &e1, &e2, &n_extra, &S, &B, &u, &misc};
  e = cudaLaunchKernel(kern, dim3(grid), dim3(kThreads), args, (size_t)smem,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
