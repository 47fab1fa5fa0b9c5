// Eval ConvGRU rollout for Hopper: one persistent cooperative launch runs
// all T steps.
//
// Replaces the Pallas TPU kernel skillful_nowcasting_tpu/ops/pallas_gru.py:_gru_kernel.
// That kernel walks a sequential (B, T) grid and keeps h in VMEM scratch for
// all T steps. Here every step is two convolutions, each followed by an
// elementwise pass, separated by cooperative_groups grid barriers:
//
//   conv A:  conv3(h, k_ru) in (tile, K-slice) units -> partial sums
//   gates A: sum the slices; r = sigmoid(. + gx_r + b_r), u = sigmoid(. + gx_u + b_u);
//            writes r * h and u
//   conv B:  conv3(r * h, k_c) -> partial sums
//   gates B: sum the slices; c = relu(. + gx_c + b_c); h' = u * h + (1 - u) * c,
//            written straight into out[t], which is step t + 1's h.
//
// conv B needs r on a one-pixel halo and step t + 1 needs all of step t, so a
// grid of independent blocks needs a barrier after each conv; the gates
// passes need the other two.
//
// What bounds it on an H100: the work is arithmetic (2 * M * 9C * 3C FLOPs a
// step, 18.3 GFLOP over 18 steps at every Sampler level), but each conv is a
// small GEMM: at the 8x8 level M = B * 64 = 128 pixels, so whole output tiles
// give 24 (conv A) and 12 (conv B) blocks for 132 SMs, each walking
// K = 9C = 3456. Run as 2 * T launches of such grids, a rollout is bound by
// latency. The design:
// - one launch per rollout; the grid is as many blocks as fit on the card
//   at once (occupancy x SMs), and each loops over a phase's work units;
// - split-K fills the card: a conv's (tile, K-slice) units number about the
//   grid, and each writes its partial tile to scratch (L2-resident). The
//   gates pass sums the slices in slice order, four channels a thread, with
//   coalesced loads spread over the whole grid. Fixed order, no atomics: the
//   same inputs give the same bits;
// - the shared 3xTF32 tensor-core mainloop of igemm.cuh (64 x 64 or 64 x 48
//   tiles on 4 warps, 3-stage cp.async ring, zero-filled halo taps);
// - the hidden weights (15.9 MB at the 8x8 level) and h stay in the 50 MB L2
//   across steps; gx[t + 1] is prefetched to L2 during step t's conv B.
// Data written inside the kernel (out, r * h, u, partials) is read through
// L2 only (cp.async.cg, __ldcg), never through the non-coherent L1.
//
// bf16 variant (gru_rollout_bf16): bf16 gx, h0, kernels, bias and out, as the
// TPU kernel instantiates for bf16 operands. As there (hpad and rpad are f32
// VMEM), h and r * h stay f32 for the whole rollout, in the f32 scratch
// hbuf and rh (u too), so no step's bf16 rounding feeds the next step: out[t]
// is a bf16 copy of h, never read back. Both convs run on the bf16 tensor
// cores (igemm.cuh's bf16 path: h and r * h rounded to bf16 as they enter
// the product, f32 sums). Bound on an H100: at the 64x64 level and B=16 the
// 146.77 GFLOP of a rollout take 0.148 ms at 989 TFLOP/s and its 460 MB of
// bf16 gx and out 0.137 ms at 3.35 TB/s, so it sits near the crossover; at
// the smaller levels it is bound by operations. Same grid, split-K and
// barrier plan as the f32 kernel; 16-byte copies need C % 8 == 0, other C
// take the masked scalar path.

#include <cooperative_groups.h>

#include "igemm.cuh"

namespace cg = cooperative_groups;

namespace dgmr {

// 64 x 64 tiles where 64 divides both convs' outputs (2C and C), 64 x 48
// otherwise: every Sampler level's C (384, 192, 96, 48) is a multiple of 48,
// so no tile column is wasted there.
using Gru64 = TileCfg<64, 64, 2, 2>;
using Gru48 = TileCfg<64, 48, 2, 2>;
constexpr int kMaxSplit = 32;      // K-slices per tile, at most
constexpr int kMinSliceTiles = 3;  // K-tiles per slice, at least (fills the ring)

struct GruArgs {
  const float* gx;    // (gx_steps, B, H, W, 3C)
  const float* h0;    // (B, H, W, C)
  const float* k_ru;  // (3, 3, C, 2C)
  const float* k_c;   // (3, 3, C, C)
  const float* bias;  // (3C,)
  float* out;         // (T, B, H, W, C)
  float* rh;          // scratch (B, H, W, C)
  float* u;           // scratch (B, H, W, C)
  float* part;        // scratch (split, B * H * W, Nout): one partial sum per K-slice
  int B, H, W, C, T, gx_steps;
  int split_a, split_b;
};

// One conv: units (tile, slice) strided over the grid; slice s of out[m][n]
// goes to part[s][m][n].
template <class Cfg, int VEC>
__device__ __forceinline__ void gru_conv(float* smem, const ConvIn& op, int M, int split,
                                         float* part) {
  const int m_tiles = cdiv(M, Cfg::BM);
  const int tiles = m_tiles * cdiv(op.Nout, Cfg::BN);
  const int k_tiles = cdiv(9 * op.Cin, Cfg::BK);
  for (int unit = blockIdx.x; unit < tiles * split; unit += gridDim.x) {
    const int tile = unit / split;
    const int slice = unit - tile * split;
    const int m0 = (tile % m_tiles) * Cfg::BM;
    const int n0 = (tile / m_tiles) * Cfg::BN;
    float acc[Cfg::MT][Cfg::NT][4] = {};
    conv_tile<Cfg, 3, VEC, false>(acc, smem, op, M, m0, n0, slice * k_tiles / split,
                                  (slice + 1) * k_tiles / split);
    float* dst = part + (size_t)slice * M * op.Nout;
    epilogue<Cfg>(
        acc, m0, n0, [](int, int, int) {},
        [&](int, int m, int n, float v) {
          if (m < M && n < op.Nout) __stcg(dst + (size_t)m * op.Nout + n, v);
        });
  }
}

// Sum of the split partials of out[m][n .. n + V) in slice order.
template <int V>
__device__ __forceinline__ void slice_sum(float (&v)[V], const float* part, int split,
                                          size_t plane, size_t o) {
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = 0.f;
#pragma unroll 4
  for (int s = 0; s < split; ++s) {
    const float* src = part + s * plane + o;
    if constexpr (V == 4) {
      const float4 p = __ldcg(reinterpret_cast<const float4*>(src));
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] += __ldcg(src + e);
    }
  }
}

// Load V floats at p (16-byte aligned when V == 4); L2 only when written in-kernel.
template <int V, bool L2_ONLY>
__device__ __forceinline__ void load_v(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = L2_ONLY ? __ldcg(reinterpret_cast<const float4*>(p))
                             : *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = L2_ONLY ? __ldcg(p + e) : p[e];
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = v[e];
  }
}

// V channels a thread (4 when C % 4 == 0, so a group never straddles a gate).
template <class Cfg, int VEC>
__global__ void __launch_bounds__(Cfg::THREADS) gru_rollout_kernel(GruArgs p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int M = p.B * p.H * p.W;
  const int C = p.C;
  const size_t mc = (size_t)M * C;
  const size_t gx_step = (size_t)M * 3 * C;
  const int groups = C / VEC;  // channel groups per gate
  const size_t first = (size_t)blockIdx.x * Cfg::THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * Cfg::THREADS;

  for (int t = 0; t < p.T; ++t) {
    const float* h = t == 0 ? p.h0 : p.out + (size_t)(t - 1) * mc;
    const float* gx = p.gx + (p.gx_steps == 1 ? 0 : (size_t)t * gx_step);
    float* h_new = p.out + (size_t)t * mc;

    gru_conv<Cfg, VEC>(smem, ConvIn{h, p.k_ru, nullptr, nullptr, p.H, p.W, C, 2 * C}, M, p.split_a,
                  p.part);
    grid.sync();

    // gx and bias channel order: read [0, C), update [C, 2C), candidate [2C, 3C).
    for (size_t i = first; i < (size_t)M * 2 * groups; i += stride) {
      const int m = static_cast<int>(i / (2 * groups));
      const int n = static_cast<int>(i - (size_t)m * 2 * groups) * VEC;
      float acc[VEC], g[VEC], b[VEC], hv[VEC];
      slice_sum<VEC>(acc, p.part, p.split_a, (size_t)M * 2 * C, (size_t)m * 2 * C + n);
      load_v<VEC, false>(g, gx + (size_t)m * 3 * C + n);
      load_v<VEC, false>(b, p.bias + n);
      const bool read = n < C;
      if (read) load_v<VEC, true>(hv, h + (size_t)m * C + n);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float gate = 1.f / (1.f + expf(-(acc[e] + g[e] + b[e])));
        acc[e] = read ? gate * hv[e] : gate;
      }
      store_v<VEC>(read ? p.rh + (size_t)m * C + n : p.u + (size_t)m * C + (n - C), acc);
    }
    grid.sync();

    if (p.gx_steps > 1 && t + 1 < p.T) {  // warm L2 with the next step's gx
      const char* next = reinterpret_cast<const char*>(gx + gx_step);
      for (size_t l = first; l < gx_step * sizeof(float) / 128; l += stride)
        prefetch_l2(next + l * 128);
    }
    gru_conv<Cfg, VEC>(smem, ConvIn{p.rh, p.k_c, nullptr, nullptr, p.H, p.W, C, C}, M, p.split_b,
                  p.part);
    grid.sync();

    for (size_t i = first; i < (size_t)M * groups; i += stride) {
      const int m = static_cast<int>(i / groups);
      const int n = static_cast<int>(i - (size_t)m * groups) * VEC;
      const size_t o = (size_t)m * C + n;
      float acc[VEC], g[VEC], b[VEC], hv[VEC], uv[VEC];
      slice_sum<VEC>(acc, p.part, p.split_b, mc, o);
      load_v<VEC, false>(g, gx + (size_t)m * 3 * C + 2 * C + n);
      load_v<VEC, false>(b, p.bias + 2 * C + n);
      load_v<VEC, true>(hv, h + o);
      load_v<VEC, true>(uv, p.u + o);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float cand = fmaxf(acc[e] + g[e] + b[e], 0.f);
        acc[e] = uv[e] * hv[e] + (1.f - uv[e]) * cand;
      }
      store_v<VEC>(h_new + o, acc);
    }
    grid.sync();
  }
}

struct GruPlan {
  const void* kernel;
  int grid, threads, smem;
  int split_a, split_b;
  long long part_floats;
};

// Grid and split-K plan for one level; deterministic for a given card.
template <class Cfg, int VEC>
cudaError_t gru_plan(int B, int H, int W, int C, GruPlan* plan) {
  int dev = 0;
  int coop = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(gru_rollout_kernel<Cfg, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_rollout_kernel<Cfg, VEC>,
                                                        Cfg::THREADS, Cfg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  plan->grid = per_sm * sm_count();
  if (plan->grid <= 0) return cudaErrorInvalidConfiguration;
  plan->kernel = reinterpret_cast<const void*>(gru_rollout_kernel<Cfg, VEC>);
  plan->threads = Cfg::THREADS;
  plan->smem = Cfg::SMEM_BYTES;
  const int M = B * H * W;
  const int k_tiles = cdiv(9 * C, Cfg::BK);
  auto split_for = [&](int nout) {
    int s = plan->grid / (cdiv(M, Cfg::BM) * cdiv(nout, Cfg::BN));
    s = s < kMaxSplit ? s : kMaxSplit;
    const int by_depth = k_tiles / kMinSliceTiles;
    s = s < by_depth ? s : by_depth;
    return s > 1 ? s : 1;
  };
  plan->split_a = split_for(2 * C);
  plan->split_b = split_for(C);
  const long long pa = (long long)plan->split_a * M * 2 * C;
  const long long pb = (long long)plan->split_b * M * C;
  plan->part_floats = pa > pb ? pa : pb;
  return cudaSuccess;
}

cudaError_t gru_plan(int B, int H, int W, int C, bool vec, GruPlan* plan) {
  if (C % 64 == 0) return vec ? gru_plan<Gru64, 4>(B, H, W, C, plan) : gru_plan<Gru64, 1>(B, H, W, C, plan);
  return vec ? gru_plan<Gru48, 4>(B, H, W, C, plan) : gru_plan<Gru48, 1>(B, H, W, C, plan);
}


// ---------------------------------------------------------------------------
// bf16 variant.

using GruBf64 = BfCfg<64, 64, 2, 2>;
using GruBf48 = BfCfg<64, 48, 2, 2>;

struct GruBfArgs {
  const uint16_t* gx;    // (gx_steps, B, H, W, 3C) bf16
  const uint16_t* h0;    // (B, H, W, C) bf16
  const uint16_t* k_ru;  // (3, 3, C, 2C) bf16
  const uint16_t* k_c;   // (3, 3, C, C) bf16
  const uint16_t* bias;  // (3C,) bf16
  uint16_t* out;         // (T, B, H, W, C) bf16
  float* hbuf;           // scratch (B, H, W, C): h in f32 for the whole rollout
  float* rh;             // scratch (B, H, W, C)
  float* u;              // scratch (B, H, W, C)
  float* part;           // scratch (split, B * H * W, Nout)
  int B, H, W, C, T, gx_steps;
  int split_a, split_b;
};

template <class Cfg, bool VEC>
__device__ __forceinline__ void gru_conv_bf(char* smem, const ConvBf<float>& op, int M, int split,
                                            float* part) {
  const int m_tiles = cdiv(M, Cfg::BM);
  const int tiles = m_tiles * cdiv(op.Nout, Cfg::BN);
  const int k_tiles = cdiv(9 * op.Cin, Cfg::BK);
  for (int unit = blockIdx.x; unit < tiles * split; unit += gridDim.x) {
    const int tile = unit / split;
    const int slice = unit - tile * split;
    const int m0 = (tile % m_tiles) * Cfg::BM;
    const int n0 = (tile / m_tiles) * Cfg::BN;
    float acc[Cfg::MT][Cfg::NT][4] = {};
    conv_tile_bf<Cfg, float, 3, VEC, false>(acc, smem, op, M, m0, n0, slice * k_tiles / split,
                                            (slice + 1) * k_tiles / split);
    float* dst = part + (size_t)slice * M * op.Nout;
    epilogue<Cfg>(
        acc, m0, n0, [](int, int, int) {},
        [&](int, int m, int n, float v) {
          if (m < M && n < op.Nout) __stcg(dst + (size_t)m * op.Nout + n, v);
        });
  }
}

// V bf16 at p (8-byte aligned when V == 4) as f32; never written in-kernel.
template <int V>
__device__ __forceinline__ void load_bf(float (&v)[V], const uint16_t* p) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_to_f32(q.x & 0xffffu);
    v[1] = bf16_to_f32(q.x >> 16);
    v[2] = bf16_to_f32(q.y & 0xffffu);
    v[3] = bf16_to_f32(q.y >> 16);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = bf16_to_f32(p[e]);
  }
}

template <int V>
__device__ __forceinline__ void store_bf(uint16_t* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = f32_to_bf16(v[e]);
  }
}

// VEC: 16-byte copies in the convs and 4 channels a thread in the gates
// (C % 8 == 0 and aligned pointers); otherwise scalar everywhere.
template <class Cfg, bool VEC>
__global__ void __launch_bounds__(Cfg::THREADS) gru_rollout_bf16_kernel(GruBfArgs p) {
  constexpr int V = VEC ? 4 : 1;
  extern __shared__ __align__(16) char smem_bf[];
  cg::grid_group grid = cg::this_grid();
  const int M = p.B * p.H * p.W;
  const int C = p.C;
  const size_t mc = (size_t)M * C;
  const size_t gx_step = (size_t)M * 3 * C;
  const int groups = C / V;
  const size_t first = (size_t)blockIdx.x * Cfg::THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * Cfg::THREADS;

  for (size_t i = first; i < mc; i += stride) p.hbuf[i] = bf16_to_f32(p.h0[i]);
  grid.sync();

  for (int t = 0; t < p.T; ++t) {
    const uint16_t* gx = p.gx + (p.gx_steps == 1 ? 0 : (size_t)t * gx_step);
    uint16_t* out_t = p.out + (size_t)t * mc;

    gru_conv_bf<Cfg, VEC>(smem_bf, ConvBf<float>{p.hbuf, p.k_ru, nullptr, nullptr, p.H, p.W, C, 2 * C},
                          M, p.split_a, p.part);
    grid.sync();

    // gx and bias channel order: read [0, C), update [C, 2C), candidate [2C, 3C).
    for (size_t i = first; i < (size_t)M * 2 * groups; i += stride) {
      const int m = static_cast<int>(i / (2 * groups));
      const int n = static_cast<int>(i - (size_t)m * 2 * groups) * V;
      float acc[V], g[V], b[V], hv[V];
      slice_sum<V>(acc, p.part, p.split_a, (size_t)M * 2 * C, (size_t)m * 2 * C + n);
      load_bf<V>(g, gx + (size_t)m * 3 * C + n);
      load_bf<V>(b, p.bias + n);
      const bool read = n < C;
      if (read) load_v<V, true>(hv, p.hbuf + (size_t)m * C + n);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float gate = 1.f / (1.f + expf(-(acc[e] + g[e] + b[e])));
        acc[e] = read ? gate * hv[e] : gate;
      }
      store_v<V>(read ? p.rh + (size_t)m * C + n : p.u + (size_t)m * C + (n - C), acc);
    }
    grid.sync();

    if (p.gx_steps > 1 && t + 1 < p.T) {  // warm L2 with the next step's gx
      const char* next = reinterpret_cast<const char*>(gx + gx_step);
      for (size_t l = first; l < gx_step * sizeof(uint16_t) / 128; l += stride)
        prefetch_l2(next + l * 128);
    }
    gru_conv_bf<Cfg, VEC>(smem_bf, ConvBf<float>{p.rh, p.k_c, nullptr, nullptr, p.H, p.W, C, C},
                          M, p.split_b, p.part);
    grid.sync();

    for (size_t i = first; i < (size_t)M * groups; i += stride) {
      const int m = static_cast<int>(i / groups);
      const int n = static_cast<int>(i - (size_t)m * groups) * V;
      const size_t o = (size_t)m * C + n;
      float acc[V], g[V], b[V], hv[V], uv[V];
      slice_sum<V>(acc, p.part, p.split_b, mc, o);
      load_bf<V>(g, gx + (size_t)m * 3 * C + 2 * C + n);
      load_bf<V>(b, p.bias + 2 * C + n);
      load_v<V, true>(hv, p.hbuf + o);
      load_v<V, true>(uv, p.u + o);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float cand = fmaxf(acc[e] + g[e] + b[e], 0.f);
        acc[e] = uv[e] * hv[e] + (1.f - uv[e]) * cand;
      }
      store_v<V>(p.hbuf + o, acc);
      store_bf<V>(out_t + o, acc);
    }
    grid.sync();
  }
}

template <class Cfg, bool VEC>
cudaError_t gru_plan_bf(int B, int H, int W, int C, GruPlan* plan) {
  int dev = 0;
  int coop = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(gru_rollout_bf16_kernel<Cfg, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_rollout_bf16_kernel<Cfg, VEC>,
                                                        Cfg::THREADS, Cfg::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  plan->grid = per_sm * sm_count();
  if (plan->grid <= 0) return cudaErrorInvalidConfiguration;
  plan->kernel = reinterpret_cast<const void*>(gru_rollout_bf16_kernel<Cfg, VEC>);
  plan->threads = Cfg::THREADS;
  plan->smem = Cfg::SMEM_BYTES;
  const int M = B * H * W;
  const int k_tiles = cdiv(9 * C, Cfg::BK);
  auto split_for = [&](int nout) {
    int s = plan->grid / (cdiv(M, Cfg::BM) * cdiv(nout, Cfg::BN));
    s = s < kMaxSplit ? s : kMaxSplit;
    const int by_depth = k_tiles / kMinSliceTiles;
    s = s < by_depth ? s : by_depth;
    return s > 1 ? s : 1;
  };
  plan->split_a = split_for(2 * C);
  plan->split_b = split_for(C);
  const long long pa = (long long)plan->split_a * M * 2 * C;
  const long long pb = (long long)plan->split_b * M * C;
  plan->part_floats = pa > pb ? pa : pb;
  return cudaSuccess;
}

cudaError_t gru_plan_bf(int B, int H, int W, int C, bool vec, GruPlan* plan) {
  if (C % 64 == 0)
    return vec ? gru_plan_bf<GruBf64, true>(B, H, W, C, plan)
               : gru_plan_bf<GruBf64, false>(B, H, W, C, plan);
  return vec ? gru_plan_bf<GruBf48, true>(B, H, W, C, plan)
             : gru_plan_bf<GruBf48, false>(B, H, W, C, plan);
}

}  // namespace dgmr

extern "C" {

const char* dgmr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of partial-sum scratch the rollout needs at this level, into
// *floats. Covers both load paths, so it holds whichever the launch picks.
int gru_rollout_workspace_f32(int B, int H, int W, int C, long long* floats) {
  dgmr::GruPlan p4{}, p1{};
  cudaError_t err = dgmr::gru_plan(B, H, W, C, true, &p4);
  if (err == cudaSuccess) err = dgmr::gru_plan(B, H, W, C, false, &p1);
  if (err != cudaSuccess) return static_cast<int>(err);
  *floats = p4.part_floats > p1.part_floats ? p4.part_floats : p1.part_floats;
  return 0;
}

// The whole rollout, one cooperative launch on `stream`; returns its cudaError_t.
int gru_rollout_f32(const float* gx, const float* h0, const float* k_ru, const float* k_c,
                    const float* bias, float* out, float* rh, float* u, float* part, int B,
                    int H, int W, int C, int T, int gx_steps, void* stream) {
  dgmr::GruArgs a{gx, h0, k_ru, k_c, bias, out, rh, u, part, B, H, W, C, T, gx_steps, 0, 0};
  const bool vec = C % 4 == 0 && dgmr::aligned16(gx) && dgmr::aligned16(h0) &&
                   dgmr::aligned16(k_ru) && dgmr::aligned16(k_c) && dgmr::aligned16(bias) &&
                   dgmr::aligned16(out) && dgmr::aligned16(rh) && dgmr::aligned16(u) &&
                   dgmr::aligned16(part);
  dgmr::GruPlan plan{};
  cudaError_t err = dgmr::gru_plan(B, H, W, C, vec, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.split_a = plan.split_a;
  a.split_b = plan.split_b;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(plan.kernel, dim3(plan.grid), dim3(plan.threads), args,
                                    plan.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// bf16 variant: scratch floats at this level, as gru_rollout_workspace_f32.
int gru_rollout_workspace_bf16(int B, int H, int W, int C, long long* floats) {
  dgmr::GruPlan p8{}, p1{};
  cudaError_t err = dgmr::gru_plan_bf(B, H, W, C, true, &p8);
  if (err == cudaSuccess) err = dgmr::gru_plan_bf(B, H, W, C, false, &p1);
  if (err != cudaSuccess) return static_cast<int>(err);
  *floats = p8.part_floats > p1.part_floats ? p8.part_floats : p1.part_floats;
  return 0;
}

// The whole bf16 rollout, one cooperative launch on `stream`; hbuf, rh and u
// are (B, H, W, C) f32 scratch. Returns its cudaError_t.
int gru_rollout_bf16(const uint16_t* gx, const uint16_t* h0, const uint16_t* k_ru,
                     const uint16_t* k_c, const uint16_t* bias, uint16_t* out, float* hbuf,
                     float* rh, float* u, float* part, int B, int H, int W, int C, int T,
                     int gx_steps, void* stream) {
  dgmr::GruBfArgs a{gx, h0, k_ru, k_c, bias, out, hbuf, rh, u, part,
                    B, H, W, C, T, gx_steps, 0, 0};
  // 16-byte copies and 4-channel gate groups (8-byte bf16, 16-byte f32 accesses).
  const bool vec = C % 8 == 0 && dgmr::aligned16(gx) && dgmr::aligned16(h0) &&
                   dgmr::aligned16(k_ru) && dgmr::aligned16(k_c) && dgmr::aligned16(bias) &&
                   dgmr::aligned16(out) && dgmr::aligned16(hbuf) && dgmr::aligned16(rh) &&
                   dgmr::aligned16(u) && dgmr::aligned16(part);
  dgmr::GruPlan plan{};
  cudaError_t err = dgmr::gru_plan_bf(B, H, W, C, vec, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.split_a = plan.split_a;
  a.split_b = plan.split_b;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(plan.kernel, dim3(plan.grid), dim3(plan.threads), args,
                                    plan.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
