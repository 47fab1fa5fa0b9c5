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
// TPU kernel instantiates for bf16 operands. As there (hpad is f32 VMEM), h
// stays f32 for the whole rollout (scratch hbuf) and feeds the gate update;
// the convs read it as bf16, which is exactly out[t - 1] (h0 at step 0), and
// conv B reads rh = bf16(r * h), stored so by gates A: the values the convs
// round their f32 inputs to anyway, so both take bf16 TMA halo boxes with no
// conversion. Bound on an H100: at the 64x64 level and B=16 the 146.77 GFLOP
// of a rollout take 0.148 ms at 989 TFLOP/s and its 460 MB of bf16 gx and out
// 0.137 ms at 3.35 TB/s; at the smaller levels and at B=2 the work is far
// smaller than the latency of 18 dependent steps. The design:
// - weight-stationary: block (pair, rank) of the persistent cooperative grid
//   owns a slice of BW output channels (48, 16 or 8, the widest whose bf16
//   weights fit beside the halo boxes: 166 KB at C = 384, 192 and 48, 111 KB
//   at C = 96) and
//   loads its k_ru read and update columns and its k_c columns into shared
//   memory by TMA once, before step 0, for all T steps;
// - two consumer warpgroups per block, each an 8x8 patch at a time, run the
//   halo-box implicit GEMM of halo_conv.cuh (wgmma, A from registers,
//   ldmatrix gathers of the taps) over the full K = 9C: no split-K and no
//   partial sums; one producer thread streams the halo boxes, and
//   setmaxnreg moves the producer warpgroup's registers to the consumers;
// - each channel's r and u (conv A) and its candidate, h and u (conv B) land
//   in one thread, so each gate pass is its conv's epilogue, and a step costs
//   two grid barriers (conv B needs all of r * h on a one-pixel halo; step
//   t + 1 needs all of out[t]), against four in the f32 kernel;
// - the slice owner of a channel computes it for the same patches at every
//   step, so h (hbuf) and u are read back by the thread that wrote them; rh
//   and out cross blocks through L2, with async-proxy fences around the
//   barriers for the TMA loads that read them;
// - a fixed K order within each patch: the same inputs give the same bits.

#include <cooperative_groups.h>

#include "halo_conv.cuh"

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
// bf16 variant: weight-stationary, wgmma + TMA.

struct GruBfArgs {
  const uint16_t* gx;    // (gx_steps, B, H, W, 3C) bf16
  const uint16_t* h0;    // (B, H, W, C) bf16
  const uint16_t* bias;  // (3C,) bf16
  uint16_t* out;         // (T, B, H, W, C) bf16
  float* hbuf;           // scratch (B, H, W, C): h in f32 for the whole rollout
  uint16_t* rh;          // scratch (B, H, W, C): bf16(r * h), conv B's input
  float* u;              // scratch (B, H, W, C): the update gate
  int B, H, W, C, T, gx_steps;
};

constexpr int kGruConsumers = 2;  // warpgroups, one 8x8 patch at a time each
constexpr int kGruThreads = 128 * (kGruConsumers + 1);  // + the producer warpgroup
constexpr int kGruAStages = 2;  // halo boxes per consumer
constexpr int kGruWeightLimit = kSmemLimit - 2048 - kGruConsumers * kGruAStages * kBoxSlot;

// Resident weight bytes of a block whose channel slice is bw wide: conv A's
// read and update columns (2 bw) and conv B's candidate columns (bw), for
// every (64-channel chunk, tap).
inline int gru_weight_bytes(int c, int bw) { return 9 * cdiv(c, kChunk) * 3 * bw * 128; }

__device__ __forceinline__ uint32_t ld_bf16x2(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// h at channels o, o + 1 in f32: h0 (bf16) at step 0, else hbuf.
__device__ __forceinline__ float2 load_h(const GruBfArgs& p, int t, size_t o) {
  if (t == 0) {
    const uint32_t v = ld_bf16x2(p.h0 + o);
    return make_float2(bf16_lo(v), bf16_hi(v));
  }
  return __ldcg(reinterpret_cast<const float2*>(p.hbuf + o));
}

// acc = conv3 of the patch whose halo boxes arrive in this consumer's ring
// (one per 64-channel chunk) with the resident weight tiles at `w` (N rows a
// (chunk, tap), chunk-major).
template <int N>
__device__ __forceinline__ void gru_conv(float (&acc)[N / 2], uint32_t w, uint32_t boxes,
                                         uint64_t* a_full, uint64_t* a_empty, Ring& a,
                                         const ALane& al, int nkc, int lane) {
  auto gather = [&](int g, uint32_t(&fr)[4][4]) {
    const int tap = g % 9;
    if (tap == 0) mbar_wait(&a_full[a.slot], a.phase);
    load_a(fr, boxes + a.slot * kBoxSlot, al, tap);
    if (tap == 8) {  // the chunk's last gather: its box is free
      __syncwarp();
      if (lane == 0) mbar_arrive(&a_empty[a.slot]);
      a.next(kGruAStages);
    }
    return w + g * N * 128;
  };
  run_groups<N>(acc, 9 * nkc, gather, [](int) {});
}

// BW: the channels of the block's slice. Block (pair, rank) holds the
// weights of channels [pair BW, pair BW + BW) for the whole rollout and
// computes those channels for patches rank * 2 + consumer, stepping by
// 2 * ranks: conv A's r and u for a channel land in one thread, and so do
// conv B's candidate, h and u, so both gate passes are epilogues.
template <int BW>
__global__ void __launch_bounds__(kGruThreads, 1)
    gru_rollout_bf16_kernel(const __grid_constant__ CUtensorMap h0_map,
                            const __grid_constant__ CUtensorMap out_map,
                            const __grid_constant__ CUtensorMap rh_map,
                            const __grid_constant__ CUtensorMap kru_map,
                            const __grid_constant__ CUtensorMap kc_map, const GruBfArgs p) {
  constexpr int NA = 2 * BW;  // conv A's columns: read | update
  constexpr int NB = BW;      // conv B's: candidate
  extern __shared__ __align__(1024) uint8_t gru_smem[];
  uint8_t* base = gru_smem + ((1024 - (smem_u32(gru_smem) & 1023)) & 1023);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(base);  // [consumer * kGruAStages + slot]
  uint64_t* a_empty = a_full + kGruConsumers * kGruAStages;
  uint64_t* w_full = a_empty + kGruConsumers * kGruAStages;
  const int nkc = cdiv(p.C, kChunk);
  const int kblocks = 9 * nkc;
  uint8_t* wa = base + 1024;
  uint8_t* wb = wa + kblocks * NA * 128;
  uint8_t* boxes = wb + kblocks * NB * 128;

  cg::grid_group grid = cg::this_grid();
  const int pairs = p.C / BW;
  const int ranks = gridDim.x / pairs;
  const int pair = blockIdx.x / ranks;
  const int rank = blockIdx.x - pair * ranks;
  const bool active = pair < pairs;  // the blocks past pairs * ranks only keep the barriers
  const int c0 = pair * BW;
  const Patches pat(p.B, p.H, p.W);
  const int units = pat.count();
  const int stride = kGruConsumers * ranks;
  const int wg = threadIdx.x / 128;
  const size_t mc = (size_t)p.B * p.H * p.W * p.C;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kGruConsumers * kGruAStages; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], 4);
    }
    mbar_init(w_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kGruConsumers) {  // producer warpgroup; one thread issues every copy
    setmaxnreg_dec<40>();
    const bool leader = active && threadIdx.x % 128 == 0;
    if (leader) {  // the block's weights, once for all T steps
      mbar_expect_tx(w_full, kblocks * (NA + NB) * 128);
      for (int k = 0; k < kblocks; ++k) {
        const int kc = k / 9, tap = k % 9;
        tma_load_3d(wa + k * NA * 128, &kru_map, w_full, kc * kChunk, tap, c0);
        tma_load_3d(wa + k * NA * 128 + BW * 128, &kru_map, w_full, kc * kChunk, tap, p.C + c0);
        tma_load_3d(wb + k * NB * 128, &kc_map, w_full, kc * kChunk, tap, c0);
      }
    }
    Ring ring[kGruConsumers];
    for (int t = 0; t < p.T; ++t) {
      for (int conv = 0; conv < 2; ++conv) {
        if (leader) {
          fence_proxy_async_global();  // other blocks' stores of out[t - 1] / rh
          // Chunk by chunk, alternating consumers, so neither waits on the other's ring.
          for (int first = rank * kGruConsumers; first < units; first += stride) {
            for (int kc = 0; kc < nkc; ++kc) {
              for (int w = 0; w < kGruConsumers && first + w < units; ++w) {
                int n, y0, x0;
                pat.at(first + w, n, y0, x0);
                Ring& r = ring[w];
                const int i = w * kGruAStages + r.slot;
                mbar_wait(&a_empty[i], r.phase ^ 1);
                mbar_expect_tx(&a_full[i], kBoxBytes);
                uint8_t* box = boxes + i * kBoxSlot;
                if (conv == 1)
                  tma_load_4d(box, &rh_map, &a_full[i], kc * kChunk, x0 - 1, y0 - 1, n);
                else if (t == 0)
                  tma_load_4d(box, &h0_map, &a_full[i], kc * kChunk, x0 - 1, y0 - 1, n);
                else
                  tma_load_5d(box, &out_map, &a_full[i], kc * kChunk, x0 - 1, y0 - 1, n, t - 1);
                r.next(kGruAStages);
              }
            }
          }
        }
        grid.sync();
      }
    }
  } else {  // consumer warpgroup wg
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const ALane al(warp, lane);
    const uint32_t my_boxes = smem_u32(boxes) + wg * kGruAStages * kBoxSlot;
    uint64_t* my_full = a_full + wg * kGruAStages;
    uint64_t* my_empty = a_empty + wg * kGruAStages;
    const int C = p.C;
    const size_t gx_step = (size_t)p.B * p.H * p.W * 3 * C;
    Ring ring;
    if (active) mbar_wait(w_full, 0);
    for (int t = 0; t < p.T; ++t) {
      const uint16_t* gx = p.gx + (p.gx_steps == 1 ? 0 : (size_t)t * gx_step);
      for (int conv = 0; conv < 2; ++conv) {
        for (int u = rank * kGruConsumers + wg; active && u < units; u += stride) {
          int n, y0, x0;
          pat.at(u, n, y0, x0);
          // This thread's rows of the patch: (2 warp + half, lane / 4).
          size_t m[2];
          bool ok[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int y = y0 + 2 * warp + half;
            const int x = x0 + lane / 4;
            ok[half] = y < p.H && x < p.W;
            m[half] = ((size_t)n * p.H + y) * p.W + x;
          }
          if (conv == 0) {
            // Gates A: r = sigmoid(conv + gx_r + b_r), u likewise; rh = bf16(r * h).
            float acc[NA / 2];
            gru_conv<NA>(acc, smem_u32(wa), my_boxes, my_full, my_empty, ring, al, nkc, lane);
#pragma unroll
            for (int j = 0; j < BW / 8; ++j) {
              const int c = c0 + 8 * j + 2 * (lane % 4);
              const uint32_t br = ld_bf16x2(p.bias + c), bu = ld_bf16x2(p.bias + C + c);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                if (!ok[half]) continue;
                const size_t o = m[half] * C + c;
                const uint16_t* g = gx + m[half] * 3 * C + c;
                const uint32_t gr = ld_bf16x2(g), gu = ld_bf16x2(g + C);
                const float2 hv = load_h(p, t, o);
                const float* ar = acc + 4 * j + 2 * half;
                const float* au = acc + 4 * (j + BW / 8) + 2 * half;
                const float r0 = sigmoid(ar[0] + bf16_lo(gr) + bf16_lo(br));
                const float r1 = sigmoid(ar[1] + bf16_hi(gr) + bf16_hi(br));
                const float u0 = sigmoid(au[0] + bf16_lo(gu) + bf16_lo(bu));
                const float u1 = sigmoid(au[1] + bf16_hi(gu) + bf16_hi(bu));
                *reinterpret_cast<uint32_t*>(p.rh + o) = bf16x2(r0 * hv.x, r1 * hv.y);
                __stcg(reinterpret_cast<float2*>(p.u + o), make_float2(u0, u1));
              }
            }
          } else {
            // Gates B: c = relu(conv + gx_c + b_c); h' = u h + (1 - u) c.
            float acc[NB / 2];
            gru_conv<NB>(acc, smem_u32(wb), my_boxes, my_full, my_empty, ring, al, nkc, lane);
#pragma unroll
            for (int j = 0; j < BW / 8; ++j) {
              const int c = c0 + 8 * j + 2 * (lane % 4);
              const uint32_t bc = ld_bf16x2(p.bias + 2 * C + c);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                if (!ok[half]) continue;
                const size_t o = m[half] * C + c;
                const uint32_t gc = ld_bf16x2(gx + m[half] * 3 * C + 2 * C + c);
                const float2 h = load_h(p, t, o);
                const float2 uu = __ldcg(reinterpret_cast<const float2*>(p.u + o));
                const float* ac = acc + 4 * j + 2 * half;
                const float cand0 = fmaxf(ac[0] + bf16_lo(gc) + bf16_lo(bc), 0.f);
                const float cand1 = fmaxf(ac[1] + bf16_hi(gc) + bf16_hi(bc), 0.f);
                const float n0 = uu.x * h.x + (1.f - uu.x) * cand0;
                const float n1 = uu.y * h.y + (1.f - uu.y) * cand1;
                __stcg(reinterpret_cast<float2*>(p.hbuf + o), make_float2(n0, n1));
                *reinterpret_cast<uint32_t*>(p.out + (size_t)t * mc + o) = bf16x2(n0, n1);
              }
            }
          }
        }
        fence_proxy_async_global();  // this thread's rh / out[t] stores, before the TMA loads
        grid.sync();
      }
    }
  }
}

struct GruBfPlan {
  const void* kernel;
  int grid, smem;
};

template <int BW>
cudaError_t gru_plan_bf(int C, GruBfPlan* plan) {
  int dev = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  plan->kernel = reinterpret_cast<const void*>(gru_rollout_bf16_kernel<BW>);
  plan->smem = 2048 + gru_weight_bytes(C, BW) + kGruConsumers * kGruAStages * kBoxSlot;
  err = cudaFuncSetAttribute(gru_rollout_bf16_kernel<BW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_rollout_bf16_kernel<BW>,
                                                        kGruThreads, plan->smem);
  if (err != cudaSuccess) return err;
  plan->grid = per_sm * sm_count();
  if (plan->grid < C / BW) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// The widest slice (48, 16 or 8 channels) that divides C and whose weights fit.
inline int gru_pick_bw(int c) {
  for (int bw : {48, 16, 8})
    if (c % bw == 0 && gru_weight_bytes(c, bw) <= kGruWeightLimit) return bw;
  return 0;
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

// The whole bf16 rollout, one cooperative launch on `stream`: gx, h0, bias and
// out bf16; k_ru (2C, 3, 3, C) and k_c (C, 3, 3, C) bf16 in OHWI; hbuf and u
// (B, H, W, C) f32 scratch, rh (B, H, W, C) bf16 scratch; C a multiple of 8,
// TMA operands 16-byte aligned. Returns its cudaError_t.
int gru_rollout_bf16(const uint16_t* gx, const uint16_t* h0, const uint16_t* k_ru,
                     const uint16_t* k_c, const uint16_t* bias, uint16_t* out, float* hbuf,
                     uint16_t* rh, float* u, int B, int H, int W, int C, int T, int gx_steps,
                     void* stream) {
  if (C % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!dgmr::aligned16(h0) || !dgmr::aligned16(k_ru) || !dgmr::aligned16(k_c) ||
      !dgmr::aligned16(out) || !dgmr::aligned16(rh) || !dgmr::aligned16(gx) ||
      !dgmr::aligned16(bias) || !dgmr::aligned16(hbuf) || !dgmr::aligned16(u))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int bw = dgmr::gru_pick_bw(C);
  if (bw == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap maps[5];
  cudaError_t err = dgmr::halo_map(&maps[0], h0, B, H, W, C);
  if (err == cudaSuccess) {
    const uint64_t dims[5] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B, (uint64_t)T};
    const uint64_t strides[4] = {2ull * C, 2ull * C * W, 2ull * C * W * H, 2ull * C * W * H * B};
    const uint32_t box[5] = {dgmr::kChunk, dgmr::kHalo, dgmr::kHalo, 1, 1};
    err = dgmr::bf16_tensor_map(&maps[1], out, 5, dims, strides, box);
  }
  if (err == cudaSuccess) err = dgmr::halo_map(&maps[2], rh, B, H, W, C);
  if (err == cudaSuccess) err = dgmr::weight_map(&maps[3], k_ru, 2 * C, 9, C, bw);
  if (err == cudaSuccess) err = dgmr::weight_map(&maps[4], k_c, C, 9, C, bw);
  dgmr::GruBfPlan plan{};
  if (err == cudaSuccess) {
    err = bw == 48   ? dgmr::gru_plan_bf<48>(C, &plan)
          : bw == 16 ? dgmr::gru_plan_bf<16>(C, &plan)
                     : dgmr::gru_plan_bf<8>(C, &plan);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dgmr::GruBfArgs a{gx, h0, bias, out, hbuf, rh, u, B, H, W, C, T, gx_steps};
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &a};
  err = cudaLaunchCooperativeKernel(plan.kernel, dim3(plan.grid), dim3(dgmr::kGruThreads), args,
                                    plan.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
