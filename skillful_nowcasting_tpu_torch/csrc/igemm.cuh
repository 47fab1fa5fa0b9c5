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


}  // namespace dgmr
