// Eval ConvGRU rollout for Hopper: one persistent cooperative launch runs
// all T steps, in f32 (3xTF32) and in bf16, both on wgmma fed by TMA
// (halo_conv.cuh, hopper.cuh).
//
// Replaces the Pallas TPU kernel skillful_nowcasting_tpu/ops/pallas_gru.py:_gru_kernel.
// That kernel walks a sequential (B, T) grid and keeps h in VMEM scratch for
// all T steps. Here every step is two 3x3 convolutions, conv3(h, k_ru) and
// conv3(r * h, k_c), each followed by its gates, separated by
// cooperative_groups grid barriers: conv B needs r on a one-pixel halo, and
// step t + 1 needs all of step t.
//
// What bounds it on an H100: the work is arithmetic (2 * M * 9C * 3C FLOPs a
// step, 18.3 GFLOP over 18 steps at every Sampler level at B=2), but each
// conv is a small GEMM: at the 8x8 level M = B * 64 = 128 pixels. So a
// rollout is bound by the latency of 2 T dependent convs, and the designs
// spend their effort on filling the card at small M with few barriers.
//
// f32 (gru_rollout_kernel): split-K with partial sums where the card needs
// them to fill, up to four barriers a step:
//
//   conv A:  conv3(h, k_ru) in (tile, K-slice) units -> partial sums
//   gates A: sum the slices; r = sigmoid(. + gx_r + b_r), u = sigmoid(. + gx_u + b_u);
//            writes r * h and u
//   conv B:  conv3(r * h, k_c) -> partial sums
//   gates B: sum the slices; c = relu(. + gx_c + b_c); h' = u * h + (1 - u) * c,
//            written straight into out[t], which is step t + 1's h.
//
// - Weight-stationary, as the bf16 kernel is, does not fit: split into TF32
//   halves the hidden weights are 31.8 MB at the 8x8 level, more than the
//   132 SMs' shared memory together. They stream from the 50 MB L2 instead,
//   where they stay across steps beside h.
// - A unit is (a pair of 8x8 patches, BN output channels, a slice of the
//   (32-channel chunk, tap) groups); split-K makes the units about as many as
//   the blocks. Each block (one per SM) runs the halo-box pipeline of
//   halo_conv.cuh (F32Pipe): a producer thread loads each group's halo boxes
//   of h (or r * h) and its [hi | lo] weight pair by TMA, two consumer
//   warpgroups (one patch each) run 3xTF32 wgmma with a fresh group
//   accumulator added on the CUDA cores per group.
// - A conv whose units fill the card without a split (the tile batch's
//   larger levels) runs its gates in its epilogue, as the bf16 kernel does:
//   the wrapper orders k_ru's outputs in blocks of 16 read then 16 update
//   channels, so each thread holds a channel's r and u. That saves the
//   partial sums' round trip through L2 and one barrier.
// - Otherwise each unit stores its partial tile to scratch (L2-resident),
//   and a gates pass over every consumer thread of the grid sums the slices
//   in slice order, four channels a thread. Fixed order, no atomics: the
//   same inputs give the same bits, and the plan (and so the bits) of a
//   level depends on its pixel count only through the number of units.
// - The producer warpgroup's other warps prefetch gx[t + 1] to L2 during
//   step t's conv B.
// Data written inside the kernel (out, r * h, u, partials) is read through
// L2 only (TMA, __ldcg), never through the non-coherent L1, and the writers
// and the producer fence the async proxy around the barriers for the TMA
// loads of out and r * h.
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

constexpr int kMaxSplit = 32;       // K-slices per tile, at most
constexpr int kMinSliceGroups = 3;  // groups per slice, at least

struct GruArgs {
  const float* gx;    // (gx_steps, B, H, W, 3C)
  const float* h0;    // (B, H, W, C)
  const float* bias;  // (3C,)
  float* out;         // (T, B, H, W, C)
  float* rh;          // scratch (B, H, W, C)
  float* u;           // scratch (B, H, W, C)
  float* part;        // scratch (split, B * H * W, Nout): one partial sum per K-slice
  int B, H, W, C, T, gx_steps;
  int split_a, split_b;
  int b_stages;
};

// The units of one conv (Nout outputs in tiles of BN, `split` K-slices of
// 9 nkc groups): unit = (pair * n_tiles + n tile) * split + slice.
struct GruUnits {
  int bn, n_tiles, split, groups, count;
  __device__ GruUnits(int pairs, int nout, int bn_, int split_, int nkc)
      : bn(bn_), n_tiles(cdiv(nout, bn_)), split(split_), groups(9 * nkc),
        count(pairs * n_tiles * split_) {}
  __device__ void at(int unit, int& mp, int& n0, int& slice, int& g0, int& g1) const {
    const int tile = unit / split;
    slice = unit - tile * split;
    mp = tile / n_tiles;
    n0 = (tile - mp * n_tiles) * bn;
    g0 = slice * groups / split;
    g1 = (slice + 1) * groups / split;
  }
};

// Producer thread: the loads of this block's units of one conv. Halo boxes
// from box_map, of step `step` of the 5-D out map, or 4-D (step < 0: h0 or
// r * h); B pairs from w_map, but the first `ahead` (gru_load_ahead).
template <int BN>
__device__ __forceinline__ void gru_load_conv(const F32Pipe& pipe, Ring& a, Ring& b,
                                              const GruUnits& un, const Patches& pat,
                                              const CUtensorMap* box_map, int step,
                                              const CUtensorMap* w_map, int ahead) {
  for (int unit = blockIdx.x; unit < un.count; unit += gridDim.x) {
    int mp, n0, slice, g0, g1;
    un.at(unit, mp, n0, slice, g0, g1);
    int pn[kConsumers], py[kConsumers], px[kConsumers];
    for (int w = 0; w < kConsumers; ++w) pat.at(kConsumers * mp + w, pn[w], py[w], px[w]);
    pipe.produce<BN>(
        a, b, g0, g1, un.groups, ahead,
        [&](int w, uint8_t* dst, uint64_t* bar, const F32Group& g) {
          const int c0 = g.kc * kChunkF32;
          if (step < 0)
            tma_load_4d(dst, box_map, bar, c0, px[w] - 1, py[w] - 1, pn[w]);
          else
            tma_load_5d(dst, box_map, bar, c0, px[w] - 1, py[w] - 1, pn[w], step);
        },
        [&](uint8_t* dst, uint64_t* bar, const F32Group& g) {
          tma_load_4d(dst, w_map, bar, g.kc * kChunkF32, g.tap, n0, 0);
        });
    ahead = ahead > g1 - g0 ? ahead - (g1 - g0) : 0;
  }
}

// Producer thread, before the barriers that end a conv: the B pairs of the
// next conv's first groups, as many as the ring holds. The weights do not
// depend on the step, so their L2 reads overlap the barriers and gates
// instead of delaying the next conv's first groups. Returns how many it
// issued (the next gru_load_conv's `ahead`).
template <int BN>
__device__ __forceinline__ int gru_load_ahead(const F32Pipe& pipe, Ring& b, const GruUnits& un,
                                              const CUtensorMap* w_map) {
  int issued = 0;
  for (int unit = blockIdx.x; unit < un.count && issued < pipe.stages; unit += gridDim.x) {
    int mp, n0, slice, g0, g1;
    un.at(unit, mp, n0, slice, g0, g1);
    for (int g = g0; g < g1 && issued < pipe.stages; ++g, ++issued)
      pipe.produce_b<BN>(b, F32Group(g, g0, g1, un.groups), [&](uint8_t* dst, uint64_t* bar,
                                                                   const F32Group& grp) {
        tma_load_4d(dst, w_map, bar, grp.kc * kChunkF32, grp.tap, n0, 0);
      });
  }
  return issued;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// conv A's output column of gate `gate` (0 read, 1 update) of channel ch:
// the wrapper orders k_ru's rows in blocks of 16 read then 16 update channels.
__host__ __device__ __forceinline__ int gate_column(int gate, int ch) {
  return (ch >> 4) * 32 + gate * 16 + (ch & 15);
}

// Consumer warpgroup wg: this block's units of conv A (CONV_A) or conv B for
// step t. Thread rows (2 warp + half, lane / 4) of its patch, columns
// n0 + 8 j + 2 (lane % 4) and + 1. Split (!GATES), each unit stores its
// partial tile to part[slice]; unsplit (GATES), the epilogue is the conv's
// gates.
template <int BN, bool CONV_A, bool GATES>
__device__ __forceinline__ void gru_run_conv(const F32Pipe& pipe, Ring& a, Ring& b, Ring& freed,
                                             const GruUnits& un, const Patches& pat, int wg,
                                             const ALane& al, int warp, int lane,
                                             const GruArgs& p, int t) {
  const int C = p.C;
  const int nout = CONV_A ? 2 * C : C;
  const size_t M = (size_t)pat.N * pat.H * pat.W;
  const size_t mc = M * C;
  const float* gx = p.gx + (p.gx_steps == 1 ? 0 : (size_t)t * 3 * mc);
  const float* h = t == 0 ? p.h0 : p.out + (size_t)(t - 1) * mc;
  for (int unit = blockIdx.x; unit < un.count; unit += gridDim.x) {
    int mp, n0, slice, g0, g1;
    un.at(unit, mp, n0, slice, g0, g1);
    float acc[BN / 2];
    pipe.consume<BN>(acc, a, b, freed, wg, al, lane, g0, g1, un.groups,
                     [](uint8_t*, const F32Group&) { return false; });
    int n, y0, x0;
    pat.at(kConsumers * mp + wg, n, y0, x0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int y = y0 + 2 * warp + half;
      const int x = x0 + lane / 4;
      if (n >= pat.N || y >= pat.H || x >= pat.W) continue;
      const size_t m = ((size_t)n * pat.H + y) * pat.W + x;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        const float* v = acc + 4 * j + 2 * half;
        if (col >= nout) continue;  // nout % 4 == 0: col + 1 is in too
        if (!GATES) {
          __stcg(reinterpret_cast<float2*>(p.part + (slice * M + m) * nout + col),
                 make_float2(v[0], v[1]));
        } else if (CONV_A) {
          // Gates A: r = sigmoid(conv + gx_r + b_r), u likewise (column col + 16, four
          // accumulators on); r * h and u.
          if (j % 4 >= 2) continue;  // update columns, taken with their read columns
          const int ch = (col >> 5) * 16 + (col & 15);
          const float* vu = v + 8;
          const float2 gr = *reinterpret_cast<const float2*>(gx + m * 3 * C + ch);
          const float2 gu = *reinterpret_cast<const float2*>(gx + m * 3 * C + C + ch);
          const float2 br = *reinterpret_cast<const float2*>(p.bias + ch);
          const float2 bu = *reinterpret_cast<const float2*>(p.bias + C + ch);
          const float2 hv = __ldcg(reinterpret_cast<const float2*>(h + m * C + ch));
          const float r0 = sigmoid(v[0] + gr.x + br.x), r1 = sigmoid(v[1] + gr.y + br.y);
          const float u0 = sigmoid(vu[0] + gu.x + bu.x), u1 = sigmoid(vu[1] + gu.y + bu.y);
          __stcg(reinterpret_cast<float2*>(p.rh + m * C + ch), make_float2(r0 * hv.x, r1 * hv.y));
          __stcg(reinterpret_cast<float2*>(p.u + m * C + ch), make_float2(u0, u1));
        } else {
          // Gates B: c = relu(conv + gx_c + b_c); h' = u h + (1 - u) c, into out[t].
          const float2 gc = *reinterpret_cast<const float2*>(gx + m * 3 * C + 2 * C + col);
          const float2 bc = *reinterpret_cast<const float2*>(p.bias + 2 * C + col);
          const float2 hv = __ldcg(reinterpret_cast<const float2*>(h + m * C + col));
          const float2 uv = __ldcg(reinterpret_cast<const float2*>(p.u + m * C + col));
          const float c0 = fmaxf(v[0] + gc.x + bc.x, 0.f), c1 = fmaxf(v[1] + gc.y + bc.y, 0.f);
          __stcg(reinterpret_cast<float2*>(p.out + (size_t)t * mc + m * C + col),
                 make_float2(uv.x * hv.x + (1.f - uv.x) * c0, uv.y * hv.y + (1.f - uv.y) * c1));
        }
      }
    }
  }
}

// Sum of the split partials of out[m][n .. n + 4) in slice order.
__device__ __forceinline__ void slice_sum(float (&v)[4], const float* part, int split,
                                          size_t plane, size_t o) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = 0.f;
#pragma unroll 8
  for (int s = 0; s < split; ++s) {
    const float4 p = __ldcg(reinterpret_cast<const float4*>(part + s * plane + o));
    v[0] += p.x;
    v[1] += p.y;
    v[2] += p.z;
    v[3] += p.w;
  }
}

// Four floats at p (16-byte aligned); L2 only when written in-kernel.
template <bool L2_ONLY>
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = L2_ONLY ? __ldcg(reinterpret_cast<const float4*>(p))
                           : *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// BNA, BNB: the output channels of a unit of conv A (2C outputs) and of
// conv B (C). Maps: h0 and out (step t's h, 5-D by step) and rh as halo
// boxes; k_ru and k_c as split OHWI pairs.
template <int BNA, int BNB>
__global__ void __launch_bounds__(kConvThreads, 1)
    gru_rollout_kernel(const __grid_constant__ CUtensorMap h0_map,
                       const __grid_constant__ CUtensorMap out_map,
                       const __grid_constant__ CUtensorMap rh_map,
                       const __grid_constant__ CUtensorMap kru_map,
                       const __grid_constant__ CUtensorMap kc_map, const GruArgs p) {
  extern __shared__ __align__(1024) uint8_t gru_smem[];
  uint8_t* base = gru_smem + ((1024 - (smem_u32(gru_smem) & 1023)) & 1023);
  const F32Pipe pipe(base, base + 1024, p.b_stages, BNA > BNB ? BNA : BNB);
  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const int C = p.C;
  const int M = p.B * p.H * p.W;
  const size_t mc = (size_t)M * C;
  const size_t gx_step = (size_t)M * 3 * C;
  const Patches pat(p.B, p.H, p.W);
  const int pairs = cdiv(pat.count(), kConsumers);
  const int nkc = cdiv(C, kChunkF32);
  const GruUnits conv_a(pairs, 2 * C, BNA, p.split_a, nkc);
  const GruUnits conv_b(pairs, C, BNB, p.split_b, nkc);
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;

  if (wg == kConsumers) {  // producer warpgroup
    setmaxnreg_dec<40>();
    const bool leader = threadIdx.x % 128 == 0;  // issues every copy of the block's units
    Ring a, b;
    int ahead = 0;  // B pairs of the next conv issued before its barriers
    for (int t = 0; t < p.T; ++t) {
      if (leader) {
        fence_proxy_async_global();  // other blocks' stores of out[t - 1]
        gru_load_conv<BNA>(pipe, a, b, conv_a, pat, t == 0 ? &h0_map : &out_map, t - 1,
                           &kru_map, ahead);
        ahead = gru_load_ahead<BNB>(pipe, b, conv_b, &kc_map);
      }
      if (p.split_a > 1) grid.sync();  // conv A's partials
      grid.sync();                     // gates A
      if (leader) {
        fence_proxy_async_global();  // other blocks' stores of r * h
        gru_load_conv<BNB>(pipe, a, b, conv_b, pat, &rh_map, -1, &kc_map, ahead);
        ahead = t + 1 < p.T ? gru_load_ahead<BNA>(pipe, b, conv_a, &kru_map) : 0;
      } else if (warp > 0 && p.gx_steps > 1 && t + 1 < p.T) {
        // Warm L2 with the next step's gx while conv B runs.
        const char* next = reinterpret_cast<const char*>(p.gx + (size_t)(t + 1) * gx_step);
        const size_t lines = gx_step * sizeof(float) / 128;
        for (size_t l = (size_t)blockIdx.x * 96 + threadIdx.x % 128 - 32; l < lines;
             l += (size_t)gridDim.x * 96)
          prefetch_l2(next + l * 128);
      }
      if (p.split_b > 1) grid.sync();  // conv B's partials
      grid.sync();                     // gates B
    }
  } else {  // consumer warpgroup wg
    setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32;
    const ALane al(warp, lane);
    const size_t first = (size_t)blockIdx.x * 128 * kConsumers + threadIdx.x;
    const size_t stride = (size_t)gridDim.x * 128 * kConsumers;
    const int groups4 = C / 4;  // channel groups of four per gate
    Ring a, b, freed;
    for (int t = 0; t < p.T; ++t) {
      const float* h = t == 0 ? p.h0 : p.out + (size_t)(t - 1) * mc;
      const float* gx = p.gx + (p.gx_steps == 1 ? 0 : (size_t)t * gx_step);

      if (p.split_a == 1) {
        gru_run_conv<BNA, true, true>(pipe, a, b, freed, conv_a, pat, wg, al, warp, lane, p, t);
      } else {
        gru_run_conv<BNA, true, false>(pipe, a, b, freed, conv_a, pat, wg, al, warp, lane, p, t);
        grid.sync();
        // Gates A. gx and bias channel order: read [0, C), update [C, 2C), candidate [2C, 3C).
        for (size_t i = first; i < (size_t)M * 2 * groups4; i += stride) {
          const int m = static_cast<int>(i / (2 * groups4));
          const int c = static_cast<int>(i - (size_t)m * 2 * groups4) * 4;
          const bool read = c < C;
          float acc[4], g[4], bv[4], hv[4];
          slice_sum(acc, p.part, p.split_a, (size_t)M * 2 * C,
                    (size_t)m * 2 * C + gate_column(read ? 0 : 1, read ? c : c - C));
          load4<false>(g, gx + (size_t)m * 3 * C + c);
          load4<false>(bv, p.bias + c);
          if (read) load4<true>(hv, h + (size_t)m * C + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gate = sigmoid(acc[e] + g[e] + bv[e]);
            acc[e] = read ? gate * hv[e] : gate;
          }
          store4(read ? p.rh + (size_t)m * C + c : p.u + (size_t)m * C + (c - C), acc);
        }
      }
      fence_proxy_async_global();  // this thread's r * h stores, before conv B's TMA loads
      grid.sync();

      if (p.split_b == 1) {
        gru_run_conv<BNB, false, true>(pipe, a, b, freed, conv_b, pat, wg, al, warp, lane, p, t);
      } else {
        gru_run_conv<BNB, false, false>(pipe, a, b, freed, conv_b, pat, wg, al, warp, lane, p, t);
        grid.sync();
        // Gates B: c = relu(conv + gx_c + b_c); h' = u h + (1 - u) c, into out[t].
        float* h_new = p.out + (size_t)t * mc;
        for (size_t i = first; i < (size_t)M * groups4; i += stride) {
          const int m = static_cast<int>(i / groups4);
          const int c = static_cast<int>(i - (size_t)m * groups4) * 4;
          const size_t o = (size_t)m * C + c;
          float acc[4], g[4], bv[4], hv[4], uv[4];
          slice_sum(acc, p.part, p.split_b, mc, o);
          load4<false>(g, gx + (size_t)m * 3 * C + 2 * C + c);
          load4<false>(bv, p.bias + 2 * C + c);
          load4<true>(hv, h + o);
          load4<true>(uv, p.u + o);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float cand = fmaxf(acc[e] + g[e] + bv[e], 0.f);
            acc[e] = uv[e] * hv[e] + (1.f - uv[e]) * cand;
          }
          store4(h_new + o, acc);
        }
      }
      fence_proxy_async_global();  // this thread's out[t] stores, before step t + 1's TMA loads
      grid.sync();
    }
  }
}

struct GruPlan {
  const void* kernel;
  int grid, smem, b_stages;
  int bn_a, bn_b;
  int split_a, split_b;
  long long part_floats;
};

// The widest unit among 128, 96 and 48 that divides n, else 64.
inline int gru_pick_bn(int n) {
  for (int bn : {128, 96, 48})
    if (n % bn == 0) return bn;
  return 64;
}

// Grid and split-K plan for one level; deterministic for a given card.
template <int BNA, int BNB>
cudaError_t gru_plan(int B, int H, int W, int C, GruPlan* plan) {
  constexpr int kMaxBn = BNA > BNB ? BNA : BNB;
  int dev = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int fixed = conv_fixed_bytes(0);
  plan->b_stages = ring_stages(fixed, 2 * kMaxBn * 128);
  plan->smem = fixed + plan->b_stages * 2 * kMaxBn * 128;
  plan->kernel = reinterpret_cast<const void*>(gru_rollout_kernel<BNA, BNB>);
  plan->bn_a = BNA;
  plan->bn_b = BNB;
  err = cudaFuncSetAttribute(gru_rollout_kernel<BNA, BNB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_rollout_kernel<BNA, BNB>,
                                                        kConvThreads, plan->smem);
  if (err != cudaSuccess) return err;
  plan->grid = per_sm * sm_count();
  if (plan->grid <= 0) return cudaErrorInvalidConfiguration;
  const int M = B * H * W;
  const int pairs = cdiv(Patches(B, H, W).count(), kConsumers);
  const int groups = 9 * cdiv(C, kChunkF32);
  auto split_for = [&](int nout, int bn) {
    int s = plan->grid / (pairs * cdiv(nout, bn));
    s = s < kMaxSplit ? s : kMaxSplit;
    const int by_depth = groups / kMinSliceGroups;
    s = s < by_depth ? s : by_depth;
    return s > 1 ? s : 1;
  };
  plan->split_a = split_for(2 * C, BNA);
  plan->split_b = split_for(C, BNB);
  const long long pa = (long long)plan->split_a * M * 2 * C;
  const long long pb = (long long)plan->split_b * M * C;
  plan->part_floats = pa > pb ? pa : pb;
  return cudaSuccess;
}

// Unit widths per level: conv B's from C, conv A's the same (2C outputs in
// twice the tiles) but at C = 48, where one 96-wide tile gathers each A
// once (the Sampler's C = 384, 192, 96, 48 take 128, 96, 96 and 96 / 48).
cudaError_t gru_plan(int B, int H, int W, int C, GruPlan* plan) {
  switch (gru_pick_bn(C)) {
    case 128: return gru_plan<128, 128>(B, H, W, C, plan);
    case 96: return gru_plan<96, 96>(B, H, W, C, plan);
    case 48: return gru_plan<96, 48>(B, H, W, C, plan);
    default: return gru_plan<64, 64>(B, H, W, C, plan);
  }
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

constexpr int kGruWeightLimit = kSmemLimit - 2048 - kConsumers * kAStages * kBoxSlot;

// Resident weight bytes of a block whose channel slice is bw wide: conv A's
// read and update columns (2 bw) and conv B's candidate columns (bw), for
// every (64-channel chunk, tap).
inline int gru_weight_bytes(int c, int bw) { return 9 * cdiv(c, kChunk) * 3 * bw * 128; }

__device__ __forceinline__ uint32_t ld_bf16x2(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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
      a.next(kAStages);
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
__global__ void __launch_bounds__(kConvThreads, 1)
    gru_rollout_bf16_kernel(const __grid_constant__ CUtensorMap h0_map,
                            const __grid_constant__ CUtensorMap out_map,
                            const __grid_constant__ CUtensorMap rh_map,
                            const __grid_constant__ CUtensorMap kru_map,
                            const __grid_constant__ CUtensorMap kc_map, const GruBfArgs p) {
  constexpr int NA = 2 * BW;  // conv A's columns: read | update
  constexpr int NB = BW;      // conv B's: candidate
  extern __shared__ __align__(1024) uint8_t gru_smem[];
  uint8_t* base = gru_smem + ((1024 - (smem_u32(gru_smem) & 1023)) & 1023);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(base);  // [consumer * kAStages + slot]
  uint64_t* a_empty = a_full + kConsumers * kAStages;
  uint64_t* w_full = a_empty + kConsumers * kAStages;
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
  const int stride = kConsumers * ranks;
  const int wg = threadIdx.x / 128;
  const size_t mc = (size_t)p.B * p.H * p.W * p.C;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers * kAStages; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], 4);
    }
    mbar_init(w_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup; one thread issues every copy
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
    Ring ring[kConsumers];
    for (int t = 0; t < p.T; ++t) {
      for (int conv = 0; conv < 2; ++conv) {
        if (leader) {
          fence_proxy_async_global();  // other blocks' stores of out[t - 1] / rh
          // Chunk by chunk, alternating consumers, so neither waits on the other's ring.
          for (int first = rank * kConsumers; first < units; first += stride) {
            for (int kc = 0; kc < nkc; ++kc) {
              for (int w = 0; w < kConsumers && first + w < units; ++w) {
                int n, y0, x0;
                pat.at(first + w, n, y0, x0);
                Ring& r = ring[w];
                const int i = w * kAStages + r.slot;
                mbar_wait(&a_empty[i], r.phase ^ 1);
                mbar_expect_tx(&a_full[i], kBoxBytes);
                uint8_t* box = boxes + i * kBoxSlot;
                if (conv == 1)
                  tma_load_4d(box, &rh_map, &a_full[i], kc * kChunk, x0 - 1, y0 - 1, n);
                else if (t == 0)
                  tma_load_4d(box, &h0_map, &a_full[i], kc * kChunk, x0 - 1, y0 - 1, n);
                else
                  tma_load_5d(box, &out_map, &a_full[i], kc * kChunk, x0 - 1, y0 - 1, n, t - 1);
                r.next(kAStages);
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
    const uint32_t my_boxes = smem_u32(boxes) + wg * kAStages * kBoxSlot;
    uint64_t* my_full = a_full + wg * kAStages;
    uint64_t* my_empty = a_empty + wg * kAStages;
    const int C = p.C;
    const size_t gx_step = (size_t)p.B * p.H * p.W * 3 * C;
    Ring ring;
    if (active) mbar_wait(w_full, 0);
    for (int t = 0; t < p.T; ++t) {
      const uint16_t* gx = p.gx + (p.gx_steps == 1 ? 0 : (size_t)t * gx_step);
      for (int conv = 0; conv < 2; ++conv) {
        for (int u = rank * kConsumers + wg; active && u < units; u += stride) {
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
  plan->smem = 2048 + gru_weight_bytes(C, BW) + kConsumers * kAStages * kBoxSlot;
  err = cudaFuncSetAttribute(gru_rollout_bf16_kernel<BW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_rollout_bf16_kernel<BW>,
                                                        kConvThreads, plan->smem);
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

// Floats of partial-sum scratch the f32 rollout needs at this level, into *floats.
int gru_rollout_workspace_f32(int B, int H, int W, int C, long long* floats) {
  dgmr::GruPlan plan{};
  const cudaError_t err = dgmr::gru_plan(B, H, W, C, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  *floats = plan.part_floats;
  return 0;
}

// The whole f32 rollout, one cooperative launch on `stream`: gx, h0, bias,
// out f32; k_ru (2, 2C, 3, 3, C) and k_c (2, C, 3, 3, C) split into TF32
// halves [hi | lo] in OHWI, k_ru's outputs in gate_column order; rh, u
// (B, H, W, C) and part (gru_rollout_workspace_f32) f32 scratch; C a
// multiple of 16, pointers 16-byte aligned. Returns its cudaError_t.
int gru_rollout_f32(const float* gx, const float* h0, const float* k_ru, const float* k_c,
                    const float* bias, float* out, float* rh, float* u, float* part, int B,
                    int H, int W, int C, int T, int gx_steps, void* stream) {
  if (C % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!dgmr::aligned16(gx) || !dgmr::aligned16(h0) || !dgmr::aligned16(k_ru) ||
      !dgmr::aligned16(k_c) || !dgmr::aligned16(bias) || !dgmr::aligned16(out) ||
      !dgmr::aligned16(rh) || !dgmr::aligned16(u) || !dgmr::aligned16(part))
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  dgmr::GruPlan plan{};
  cudaError_t err = dgmr::gru_plan(B, H, W, C, &plan);
  CUtensorMap maps[5];
  if (err == cudaSuccess) err = dgmr::halo_map(&maps[0], kF32, h0, B, H, W, C);
  if (err == cudaSuccess) err = dgmr::step_halo_map(&maps[1], kF32, out, B, H, W, C, T);
  if (err == cudaSuccess) err = dgmr::halo_map(&maps[2], kF32, rh, B, H, W, C);
  if (err == cudaSuccess) err = dgmr::weight_pair_map(&maps[3], k_ru, 2 * C, 9, C, plan.bn_a);
  if (err == cudaSuccess) err = dgmr::weight_pair_map(&maps[4], k_c, C, 9, C, plan.bn_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  dgmr::GruArgs a{gx, h0, bias, out, rh, u, part, B, H, W, C, T, gx_steps,
                  plan.split_a, plan.split_b, plan.b_stages};
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &a};
  err = cudaLaunchCooperativeKernel(plan.kernel, dim3(plan.grid), dim3(dgmr::kConvThreads), args,
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
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[5];
  cudaError_t err = dgmr::halo_map(&maps[0], kBf16, h0, B, H, W, C);
  if (err == cudaSuccess)
    err = dgmr::step_halo_map(&maps[1], kBf16, out, B, H, W, C, T);
  if (err == cudaSuccess) err = dgmr::halo_map(&maps[2], kBf16, rh, B, H, W, C);
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
  err = cudaLaunchCooperativeKernel(plan.kernel, dim3(plan.grid), dim3(dgmr::kConvThreads), args,
                                    plan.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
