// Implicit-GEMM convolution mainloop shared by the port's hand-written kernels
// (gru_rollout.cu for skillful_nowcasting_tpu/ops/pallas_gru.py:_gru_kernel,
// gblock_fused.cu for skillful_nowcasting_tpu/ops/pallas_gblock.py:_gblock_kernel):
// 3xTF32 on the tensor cores, fed by a cp.async ring.
//
// A stride-1 SAME convolution over an NHWC activation is a matrix product
// out[m][n] = sum_k A[m][k] * Wt[k][n] with
//   m = pixel (b, y, x)                     M = B * H * W rows,
//   k = (tap, ci), tap = dy * KS + dx       K = KS * KS * Cin,
//   A[m][k] = in[b, y + dy - KS/2, x + dx - KS/2, ci], 0 outside the image,
// and Wt the HWIO kernel read as a row-major (K, Nout) matrix: HWIO already
// stores (dy, dx, ci) slowest to fastest, so no weight reshuffle is needed.
//
// What bounds it on an H100: arithmetic. At the Sampler's shapes both users
// do hundreds of FLOPs per byte they must move. f32 FMA on the CUDA cores
// tops out at 67 TFLOP/s; the tensor cores do TF32 at 495 TFLOP/s. One TF32
// product keeps ~11 bits and misses the port's 1e-4 parity, so each f32
// operand is split into a TF32 high part and a TF32 remainder (bit masks,
// ptx.cuh) and three products are summed in f32 (lo*hi + hi*lo + hi*hi; the
// dropped lo*lo is ~2^-20 of a product): near-f32 error at a third of the
// TF32 rate, 165 TFLOP/s. mma.sync, the warp-level instruction used here,
// reaches only part of that rate on Hopper, and the split costs ALU
// instructions per product; the asynchronous warpgroup wgmma is the way to
// the full rate.
//
// Design:
// - A block of Cfg::THREADS threads computes a BM x BN tile of `out`; each
//   warp a WM x WN sub-tile as (WM/16) x (WN/8) mma.sync.m16n8k8 tiles.
// - K advances BK = 32 at a time through a STAGES-deep ring in dynamic shared
//   memory. Operands arrive by 16-byte cp.async.cg (L2 only, so data written
//   by other blocks earlier in the same kernel is never stale), with
//   out-of-image taps and the ragged K / N edges zero-filled. Channel counts
//   that are not a multiple of 4 (VEC = 1) take masked scalar loads instead.
// - The smem row strides (BK + 4 and BN + 8 floats) make every fragment load
//   of a warp hit 32 distinct banks.
// - The tensor cores truncate their own f32 adds, so each K-tile's products
//   are summed from 0 and added to the running sum on the CUDA cores (round
//   to nearest).
// - With AFFINE the gathered activation is relu(scale[ci] * v + shift[ci]):
//   the raw value lands in shared memory and the thread that fetched it
//   rewrites it there, in-image taps only. SAME padding applies after the
//   affine, so zero-filled taps stay 0 and never become relu(shift).
//
// bf16 path (the second half of this file): the same implicit GEMM with bf16
// weights (B) and an A operand that is bf16 (the GBlock's x) or f32 (the
// GRU's h and r * h, the GBlock's mid, which the TPU kernels keep in f32
// too). A lands in shared memory in its own type; an f32 value is rounded
// to bf16 (round to nearest even) as it enters the product, as a TPU MXU
// rounds an f32 dot at default precision. One mma.sync.m16n8k16 per 16-deep
// K-step, f32 accumulators, the same per-K-tile round-to-nearest summation.
// bf16 runs the tensor cores at 989 TFLOP/s dense (against 165 for 3xTF32).
// A 16-byte copy holds 8 bf16 or 4 f32, so the vector path needs the channel
// counts to be multiples of 8 (A bf16, and B's Nout) or 4 (A f32); other
// counts take masked scalar loads.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace dgmr {

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct TileCfg {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int BK = 32;
  static constexpr int STAGES = 3;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;  // m16 tiles per warp
  static constexpr int NT = WN / 8;   // n8 tiles per warp
  static constexpr int ACC = MT * NT * 4;  // accumulators per thread
  static constexpr int A_LD = BK + 4;  // smem row strides, in floats
  static constexpr int B_LD = BN + 8;
  static constexpr int A_STAGE = BM * A_LD;
  static constexpr int B_STAGE = BK * B_LD;
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;
  static constexpr int A_ITERS = BM * BK / 4 / THREADS;  // 4-float A chunks per thread
  static constexpr int B_ITERS = BK * BN / 4 / THREADS;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile must be whole mma tiles");
  static_assert(A_ITERS * THREADS * 4 == BM * BK, "A tile must split evenly over threads");
  static_assert(B_ITERS * THREADS * 4 == BK * BN, "B tile must split evenly over threads");
  static_assert(THREADS % (BK / 4) == 0, "a thread's K column must be fixed");
};

// One convolution operand pair: the NHWC input and the HWIO kernel (K, Nout).
struct ConvIn {
  const float* in;
  const float* wgt;
  const float* scale;  // AFFINE only: per input channel
  const float* shift;
  int H, W, Cin, Nout;
};

// The A rows (pixels) this thread fetches; fixed for one output tile.
template <class Cfg>
struct ARows {
  int base[Cfg::A_ITERS];  // b * H * W of the row's image, -1 past M
  int y[Cfg::A_ITERS];
  int x[Cfg::A_ITERS];
};

template <class Cfg>
__device__ __forceinline__ void a_rows(ARows<Cfg>& r, int m0, int M, int H, int W) {
  const int hw = H * W;
#pragma unroll
  for (int i = 0; i < Cfg::A_ITERS; ++i) {
    const int m = m0 + threadIdx.x / (Cfg::BK / 4) + i * (Cfg::THREADS / (Cfg::BK / 4));
    if (m < M) {
      const int b = m / hw;
      const int rem = m - b * hw;
      r.base[i] = b * hw;
      r.y[i] = rem / W;
      r.x[i] = rem - r.y[i] * W;
    } else {
      r.base[i] = -1;
      r.y[i] = 0;
      r.x[i] = 0;
    }
  }
}

// Pixel index of row i shifted by (dy, dx), or -1 outside the image / past M.
template <class Cfg>
__device__ __forceinline__ int tap_pixel(const ARows<Cfg>& r, int i, int dy, int dx, int H, int W) {
  const int yy = r.y[i] + dy;
  const int xx = r.x[i] + dx;
  const bool ok = r.base[i] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W;
  return ok ? r.base[i] + yy * W + xx : -1;
}

// Start the loads of K-tile [k0, k0 + BK) into one ring stage.
template <class Cfg, int KS, int VEC>
__device__ __forceinline__ void load_stage(float* sA, float* sB, const ARows<Cfg>& r,
                                           const ConvIn& op, int K, int k0, int n0) {
  constexpr int PAD = KS / 2;
  constexpr int KC = Cfg::BK / 4;  // 4-float chunks per A row
  const int tid = threadIdx.x;
  const int kc = k0 + 4 * (tid % KC);
  float* a_dst = sA + (tid / KC) * Cfg::A_LD + 4 * (tid % KC);
  constexpr int A_ROW_STEP = (Cfg::THREADS / KC) * Cfg::A_LD;

  if (VEC == 4) {  // Cin % 4 == 0: the chunk's 4 k share one tap; K % 4 == 0
    const bool kin = kc < K;
    const int tap = kin ? kc / op.Cin : 0;
    const int ci = kc - tap * op.Cin;
    const int dy = tap / KS - PAD;
    const int dx = tap % KS - PAD;
#pragma unroll
    for (int i = 0; i < Cfg::A_ITERS; ++i) {
      const int p = kin ? tap_pixel(r, i, dy, dx, op.H, op.W) : -1;
      const float* src = p >= 0 ? op.in + (size_t)p * op.Cin + ci : op.in;
      cp_async16(a_dst + i * A_ROW_STEP, src, p >= 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = kc + e;
      const bool kin = k < K;
      const int tap = kin ? k / op.Cin : 0;
      const int ci = k - tap * op.Cin;
      const int dy = tap / KS - PAD;
      const int dx = tap % KS - PAD;
#pragma unroll
      for (int i = 0; i < Cfg::A_ITERS; ++i) {
        const int p = kin ? tap_pixel(r, i, dy, dx, op.H, op.W) : -1;
        a_dst[i * A_ROW_STEP + e] = p >= 0 ? __ldcg(op.in + (size_t)p * op.Cin + ci) : 0.f;
      }
    }
  }

  constexpr int NC = Cfg::BN / 4;  // 4-float chunks per B row
#pragma unroll
  for (int j = 0; j < Cfg::B_ITERS; ++j) {
    const int c = tid + j * Cfg::THREADS;
    const int kr = c / NC;
    const int nc = 4 * (c - kr * NC);
    const int k = k0 + kr;
    const int n = n0 + nc;
    float* dst = sB + kr * Cfg::B_LD + nc;
    if (VEC == 4) {  // Nout % 4 == 0
      const bool ok = k < K && n < op.Nout;
      cp_async16(dst, ok ? op.wgt + (size_t)k * op.Nout + n : op.wgt, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k < K && n + e < op.Nout;
        dst[e] = ok ? __ldcg(op.wgt + (size_t)k * op.Nout + n + e) : 0.f;
      }
    }
  }
}

// AFFINE: rewrite this thread's own A chunks of a landed stage as
// relu(scale * v + shift), in-image taps only. scale and shift are in shared
// memory (a global load here would stall every K-tile before its barrier).
template <class Cfg, int KS, int VEC>
__device__ __forceinline__ void affine_stage(float* sA, const ARows<Cfg>& r, const ConvIn& op,
                                             int K, int k0) {
  constexpr int PAD = KS / 2;
  constexpr int KC = Cfg::BK / 4;
  const int tid = threadIdx.x;
  const int kc = k0 + 4 * (tid % KC);
  float* a_dst = sA + (tid / KC) * Cfg::A_LD + 4 * (tid % KC);
  constexpr int A_ROW_STEP = (Cfg::THREADS / KC) * Cfg::A_LD;
  constexpr int GROUP = VEC == 4 ? 4 : 1;  // k values that share one tap
#pragma unroll
  for (int e0 = 0; e0 < 4; e0 += GROUP) {
    const int k = kc + e0;
    if (k >= K) break;
    const int tap = k / op.Cin;
    const int ci = k - tap * op.Cin;
#pragma unroll
    for (int i = 0; i < Cfg::A_ITERS; ++i) {
      if (tap_pixel(r, i, tap / KS - PAD, tap % KS - PAD, op.H, op.W) < 0) continue;
#pragma unroll
      for (int e = 0; e < GROUP; ++e) {
        float& v = a_dst[i * A_ROW_STEP + e0 + e];
        v = fmaxf(fmaf(op.scale[ci + e], v, op.shift[ci + e]), 0.f);
      }
    }
  }
}

// acc += the stage's BM x BK by BK x BN product, 3xTF32 on the tensor cores.
// The tensor cores truncate when they add into an f32 accumulator; summed
// straight into acc over K = 6912 that bias reached 2.2e-4. So the stage's
// products start from 0 and reach acc through one IEEE (round-to-nearest)
// add per K-tile. Each of the three products runs over all tiles before the
// next, so no mma waits on the one before it.
template <class Cfg>
__device__ __forceinline__ void mma_stage(float (&acc)[Cfg::MT][Cfg::NT][4], const float* sA,
                                          const float* sB) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* a_base = sA + ((warp / Cfg::WARPS_N) * Cfg::WM + g) * Cfg::A_LD + t;
  const float* b_base = sB + t * Cfg::B_LD + (warp % Cfg::WARPS_N) * Cfg::WN + g;
  float part[Cfg::MT][Cfg::NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < Cfg::BK; kk += 8) {
    uint32_t ah[Cfg::MT][4], al[Cfg::MT][4], bh[Cfg::NT][2], bl[Cfg::NT][2];
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt) {
      const float* a = a_base + mt * 16 * Cfg::A_LD + kk;
      split_tf32(a[0], ah[mt][0], al[mt][0]);                   // (g,     t)
      split_tf32(a[8 * Cfg::A_LD], ah[mt][1], al[mt][1]);       // (g + 8, t)
      split_tf32(a[4], ah[mt][2], al[mt][2]);                   // (g,     t + 4)
      split_tf32(a[8 * Cfg::A_LD + 4], ah[mt][3], al[mt][3]);   // (g + 8, t + 4)
    }
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt) {
      const float* b = b_base + kk * Cfg::B_LD + nt * 8;
      split_tf32(b[0], bh[nt][0], bl[nt][0]);               // (k = t,     n = g)
      split_tf32(b[4 * Cfg::B_LD], bh[nt][1], bl[nt][1]);   // (k = t + 4, n = g)
    }
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Cfg::NT; ++nt) mma_tf32(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Cfg::NT; ++nt) mma_tf32(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Cfg::NT; ++nt) mma_tf32(part[mt][nt], ah[mt], bh[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
}

// acc += A[m0 : m0 + BM, K-tiles kt0..kt1) x Wt[.., n0 : n0 + BN) for one
// convolution. smem holds Cfg::SMEM_BYTES; the block is free to reuse it on
// return (every copy landed, every thread past its last read).
template <class Cfg, int KS, int VEC, bool AFFINE>
__device__ __forceinline__ void conv_tile(float (&acc)[Cfg::MT][Cfg::NT][4], float* smem,
                                          const ConvIn& op, int M, int m0, int n0, int kt0,
                                          int kt1) {
  ARows<Cfg> r;
  a_rows<Cfg>(r, m0, M, op.H, op.W);
  const int K = KS * KS * op.Cin;
  float* sA = smem;
  float* sB = smem + Cfg::STAGES * Cfg::A_STAGE;
  const int nk = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < nk) {
      load_stage<Cfg, KS, VEC>(sA + s * Cfg::A_STAGE, sB + s * Cfg::B_STAGE, r, op, K,
                               (kt0 + s) * Cfg::BK, n0);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<Cfg::STAGES - 2>();  // K-tile i has landed (this thread's copies)
    const int st = i % Cfg::STAGES;
    if (AFFINE) affine_stage<Cfg, KS, VEC>(sA + st * Cfg::A_STAGE, r, op, K, (kt0 + i) * Cfg::BK);
    __syncthreads();  // ... for every thread; and everyone is done with tile i - 1
    const int nxt = i + Cfg::STAGES - 1;
    if (nxt < nk) {
      const int sn = nxt % Cfg::STAGES;  // the stage of tile i - 1
      load_stage<Cfg, KS, VEC>(sA + sn * Cfg::A_STAGE, sB + sn * Cfg::B_STAGE, r, op, K,
                               (kt0 + nxt) * Cfg::BK, n0);
    }
    cp_async_commit();
    mma_stage<Cfg>(acc, sA + st * Cfg::A_STAGE, sB + st * Cfg::B_STAGE);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Epilogue over this thread's accumulators, one m16 row block at a time:
// load(j, m, n) for the block's NT * 4 elements first, then
// store(j, m, n, value). As far as the compiler knows the stores may alias the
// loaded buffers, so interleaving the two would cost one memory round trip
// per element. Callers mask m and n.
template <class Cfg, class L, class S>
__device__ __forceinline__ void epilogue(const float (&acc)[Cfg::MT][Cfg::NT][4], int m0, int n0,
                                         L&& load, S&& store) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int mb = m0 + (warp / Cfg::WARPS_N) * Cfg::WM + (lane >> 2);
  const int nb = n0 + (warp % Cfg::WARPS_N) * Cfg::WN + 2 * (lane & 3);
  // q = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        load(nt * 4 + q, mb + mt * 16 + 8 * (q >> 1), nb + nt * 8 + (q & 1));
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        store(nt * 4 + q, mb + mt * 16 + 8 * (q >> 1), nb + nt * 8 + (q & 1), acc[mt][nt][q]);
  }
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Streaming multiprocessors of the current device, or 0 on error.
inline int sm_count() {
  int dev = 0;
  int n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }


// ---------------------------------------------------------------------------
// bf16 tensor-core path.

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct BfCfg {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int BK = 32;  // two m16n8k16 steps per ring stage
  static constexpr int STAGES = 3;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  // A rows are BK + 8 elements of their type: a warp's fragment loads (8-byte
  // float pairs, 4-byte bf16 pairs) then hit distinct banks. B rows are
  // BN + 8 bf16, 16-byte aligned for cp.async and conflict-free for the
  // k-pair loads of the B fragments.
  static constexpr int A_LD = BK + 8;
  static constexpr int B_LD = BN + 8;
  static constexpr int A_STAGE_BYTES = BM * A_LD * 4;  // room for f32 A (bf16 A uses half)
  static constexpr int B_STAGE_BYTES = BK * B_LD * 2;
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE_BYTES + B_STAGE_BYTES);
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile must be whole mma tiles");
  static_assert((B_LD * 2) % 16 == 0 && (A_LD * 2) % 16 == 0, "rows must stay 16-byte aligned");
};

// How one A element type (float, or bf16 bits as uint16_t) splits into 16-byte chunks.
template <class Cfg, class TA>
struct AChunks {
  static constexpr int VEC = 16 / sizeof(TA);  // elements per chunk: 4 f32 or 8 bf16
  static constexpr int KC = Cfg::BK / VEC;     // chunks per A row
  static constexpr int ROW_STEP = Cfg::THREADS / KC;
  static constexpr int ITERS = Cfg::BM * Cfg::BK / VEC / Cfg::THREADS;
  static_assert(ITERS * Cfg::THREADS * VEC == Cfg::BM * Cfg::BK, "A tile must split evenly");
  static_assert(Cfg::THREADS % KC == 0, "a thread's K column must be fixed");
};

template <class TA>
struct ConvBf {
  const TA* in;         // NHWC activation, f32 or bf16 bits
  const uint16_t* wgt;  // HWIO kernel (K, Nout), bf16 bits
  const float* scale;   // AFFINE only: per input channel (shared memory)
  const float* shift;
  int H, W, Cin, Nout;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) { return bf16_to_f32(v); }
template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint16_t from_f32<uint16_t>(float v) { return f32_to_bf16(v); }
// L2-only scalar loads: data written earlier in the same kernel is never stale.
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ uint16_t load_cg(const uint16_t* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}

// The A rows this thread fetches for element type TA.
template <class Cfg, class TA>
struct ARowsBf {
  int base[AChunks<Cfg, TA>::ITERS];
  int y[AChunks<Cfg, TA>::ITERS];
  int x[AChunks<Cfg, TA>::ITERS];
};

template <class Cfg, class TA>
__device__ __forceinline__ void a_rows_bf(ARowsBf<Cfg, TA>& r, int m0, int M, int H, int W) {
  using S = AChunks<Cfg, TA>;
  const int hw = H * W;
#pragma unroll
  for (int i = 0; i < S::ITERS; ++i) {
    const int m = m0 + threadIdx.x / S::KC + i * S::ROW_STEP;
    if (m < M) {
      const int b = m / hw;
      const int rem = m - b * hw;
      r.base[i] = b * hw;
      r.y[i] = rem / W;
      r.x[i] = rem - r.y[i] * W;
    } else {
      r.base[i] = -1;
      r.y[i] = 0;
      r.x[i] = 0;
    }
  }
}

template <class R>
__device__ __forceinline__ int tap_pixel_bf(const R& r, int i, int dy, int dx, int H, int W) {
  const int yy = r.y[i] + dy;
  const int xx = r.x[i] + dx;
  const bool ok = r.base[i] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W;
  return ok ? r.base[i] + yy * W + xx : -1;
}

// Start the loads of K-tile [k0, k0 + BK) into one ring stage. VEC: 16-byte
// copies (Cin a multiple of the A chunk, Nout of 8, pointers 16-byte aligned).
template <class Cfg, class TA, int KS, bool VEC>
__device__ __forceinline__ void load_stage_bf(TA* sA, uint16_t* sB, const ARowsBf<Cfg, TA>& r,
                                              const ConvBf<TA>& op, int K, int k0, int n0) {
  using S = AChunks<Cfg, TA>;
  constexpr int PAD = KS / 2;
  const int tid = threadIdx.x;
  const int kc = k0 + S::VEC * (tid % S::KC);
  TA* a_dst = sA + (tid / S::KC) * Cfg::A_LD + S::VEC * (tid % S::KC);
  constexpr int A_ROW_STEP = S::ROW_STEP * Cfg::A_LD;

  if (VEC) {  // the chunk's VEC k share one tap; K % VEC == 0
    const bool kin = kc < K;
    const int tap = kin ? kc / op.Cin : 0;
    const int ci = kc - tap * op.Cin;
    const int dy = tap / KS - PAD;
    const int dx = tap % KS - PAD;
#pragma unroll
    for (int i = 0; i < S::ITERS; ++i) {
      const int p = kin ? tap_pixel_bf(r, i, dy, dx, op.H, op.W) : -1;
      const TA* src = p >= 0 ? op.in + (size_t)p * op.Cin + ci : op.in;
      cp_async16(a_dst + i * A_ROW_STEP, src, p >= 0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < S::VEC; ++e) {
      const int k = kc + e;
      const bool kin = k < K;
      const int tap = kin ? k / op.Cin : 0;
      const int ci = k - tap * op.Cin;
      const int dy = tap / KS - PAD;
      const int dx = tap % KS - PAD;
#pragma unroll
      for (int i = 0; i < S::ITERS; ++i) {
        const int p = kin ? tap_pixel_bf(r, i, dy, dx, op.H, op.W) : -1;
        a_dst[i * A_ROW_STEP + e] = p >= 0 ? load_cg(op.in + (size_t)p * op.Cin + ci) : TA(0);
      }
    }
  }

  constexpr int NC = Cfg::BN / 8;  // 8-element chunks per B row
  constexpr int CHUNKS = Cfg::BK * NC;
#pragma unroll
  for (int c = tid; c < CHUNKS; c += Cfg::THREADS) {
    const int kr = c / NC;
    const int nc = 8 * (c - kr * NC);
    const int k = k0 + kr;
    const int n = n0 + nc;
    uint16_t* dst = sB + kr * Cfg::B_LD + nc;
    if (VEC) {
      const bool ok = k < K && n < op.Nout;
      cp_async16(dst, ok ? op.wgt + (size_t)k * op.Nout + n : op.wgt, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool ok = k < K && n + e < op.Nout;
        dst[e] = ok ? op.wgt[(size_t)k * op.Nout + n + e] : uint16_t(0);
      }
    }
  }
}

// AFFINE: rewrite this thread's own A chunks of a landed stage as
// relu(scale * v + shift), computed in f32 and stored in TA (bf16: rounded
// once, as it enters the product). In-image taps only.
template <class Cfg, class TA, int KS, bool VEC>
__device__ __forceinline__ void affine_stage_bf(TA* sA, const ARowsBf<Cfg, TA>& r,
                                                const ConvBf<TA>& op, int K, int k0) {
  using S = AChunks<Cfg, TA>;
  constexpr int PAD = KS / 2;
  const int tid = threadIdx.x;
  const int kc = k0 + S::VEC * (tid % S::KC);
  TA* a_dst = sA + (tid / S::KC) * Cfg::A_LD + S::VEC * (tid % S::KC);
  constexpr int A_ROW_STEP = S::ROW_STEP * Cfg::A_LD;
  constexpr int GROUP = VEC ? S::VEC : 1;  // k values that share one tap
#pragma unroll
  for (int e0 = 0; e0 < S::VEC; e0 += GROUP) {
    const int k = kc + e0;
    if (k >= K) break;
    const int tap = k / op.Cin;
    const int ci = k - tap * op.Cin;
#pragma unroll
    for (int i = 0; i < S::ITERS; ++i) {
      if (tap_pixel_bf(r, i, tap / KS - PAD, tap % KS - PAD, op.H, op.W) < 0) continue;
#pragma unroll
      for (int e = 0; e < GROUP; ++e) {
        TA& v = a_dst[i * A_ROW_STEP + e0 + e];
        v = from_f32<TA>(fmaxf(fmaf(op.scale[ci + e], to_f32(v), op.shift[ci + e]), 0.f));
      }
    }
  }
}

// A fragment register: the elements at p and p + 1 (consecutive k) as bf16x2.
__device__ __forceinline__ uint32_t a_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t a_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += the stage's BM x BK by BK x BN product on the bf16 tensor cores,
// summed from 0 per K-tile and added to acc on the CUDA cores.
template <class Cfg, class TA>
__device__ __forceinline__ void mma_stage_bf(float (&acc)[Cfg::MT][Cfg::NT][4], const TA* sA,
                                             const uint16_t* sB) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const TA* a_base = sA + ((warp / Cfg::WARPS_N) * Cfg::WM + g) * Cfg::A_LD + 2 * t;
  const uint16_t* b_base = sB + 2 * t * Cfg::B_LD + (warp % Cfg::WARPS_N) * Cfg::WN + g;
  float part[Cfg::MT][Cfg::NT][4] = {};
#pragma unroll
  for (int kk = 0; kk < Cfg::BK; kk += 16) {
    uint32_t a[Cfg::MT][4], b[Cfg::NT][2];
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt) {
      const TA* p = a_base + mt * 16 * Cfg::A_LD + kk;
      a[mt][0] = a_pair(p);                      // (g,     2t)
      a[mt][1] = a_pair(p + 8 * Cfg::A_LD);      // (g + 8, 2t)
      a[mt][2] = a_pair(p + 8);                  // (g,     2t + 8)
      a[mt][3] = a_pair(p + 8 * Cfg::A_LD + 8);  // (g + 8, 2t + 8)
    }
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt) {
      const uint16_t* q = b_base + kk * Cfg::B_LD + nt * 8;
      b[nt][0] = q[0] | (static_cast<uint32_t>(q[Cfg::B_LD]) << 16);              // k = 2t, 2t + 1
      b[nt][1] = q[8 * Cfg::B_LD] | (static_cast<uint32_t>(q[9 * Cfg::B_LD]) << 16);  // k + 8
    }
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Cfg::NT; ++nt) mma_bf16(part[mt][nt], a[mt], b[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
}

// acc += A[m0 : m0 + BM, K-tiles kt0..kt1) x Wt[.., n0 : n0 + BN) for one
// convolution on the bf16 tensor cores; smem holds Cfg::SMEM_BYTES and is
// free again on return.
template <class Cfg, class TA, int KS, bool VEC, bool AFFINE>
__device__ __forceinline__ void conv_tile_bf(float (&acc)[Cfg::MT][Cfg::NT][4], char* smem,
                                             const ConvBf<TA>& op, int M, int m0, int n0,
                                             int kt0, int kt1) {
  ARowsBf<Cfg, TA> r;
  a_rows_bf<Cfg, TA>(r, m0, M, op.H, op.W);
  const int K = KS * KS * op.Cin;
  constexpr int A_STAGE = Cfg::A_STAGE_BYTES / (int)sizeof(TA);  // in elements
  constexpr int B_STAGE = Cfg::BK * Cfg::B_LD;
  TA* sA = reinterpret_cast<TA*>(smem);
  uint16_t* sB = reinterpret_cast<uint16_t*>(smem + Cfg::STAGES * Cfg::A_STAGE_BYTES);
  const int nk = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < nk) {
      load_stage_bf<Cfg, TA, KS, VEC>(sA + s * A_STAGE, sB + s * B_STAGE, r, op, K,
                                      (kt0 + s) * Cfg::BK, n0);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<Cfg::STAGES - 2>();  // K-tile i has landed (this thread's copies)
    const int st = i % Cfg::STAGES;
    if (AFFINE) affine_stage_bf<Cfg, TA, KS, VEC>(sA + st * A_STAGE, r, op, K, (kt0 + i) * Cfg::BK);
    __syncthreads();  // ... for every thread; and everyone is done with tile i - 1
    const int nxt = i + Cfg::STAGES - 1;
    if (nxt < nk) {
      const int sn = nxt % Cfg::STAGES;
      load_stage_bf<Cfg, TA, KS, VEC>(sA + sn * A_STAGE, sB + sn * B_STAGE, r, op, K,
                                      (kt0 + nxt) * Cfg::BK, n0);
    }
    cp_async_commit();
    mma_stage_bf<Cfg, TA>(acc, sA + st * A_STAGE, sB + st * B_STAGE);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace dgmr
