// Eval GBlock for Hopper: two implicit-GEMM launches on the tensor-core
// mainloop of igemm.cuh.
//
// Replaces the Pallas TPU kernel skillful_nowcasting_tpu/ops/pallas_gblock.py:_gblock_kernel:
//
//   out = conv3(relu(a2 * conv3(relu(a1 * x + b1), k1) + b2), k2) + (conv1x1(x, ksc) | x) + b_out
//
// with BN folded into the affines (a1, b1, a2, b2) and spectral norm into the
// kernels; conv1's bias is folded into b2 and conv2's (and the shortcut's)
// into b_out by fold_gblock_variables.
//
//   gblock_conv1: relu(a1 * x + b1) applied to the gathered x in shared
//                 memory -> conv3(k1) -> epilogue relu(a2 * y + b2) -> mid.
//   gblock_conv2: conv3(mid, k2), then the 1x1 shortcut as more K-tiles of the
//                 same accumulator (or the identity in the epilogue) + b_out.
//
// SAME zero padding applies after the affine and the ReLU: cp.async lands the
// raw x, and only in-image taps are rewritten to relu(a1 * x + b1); padded
// taps stay 0 (not relu(b1)). mid rows outside the image are never gathered
// (the TPU kernel masks them, pallas_gblock.py:108-143).
//
// What bounds it on an H100: arithmetic. At the Sampler's shapes (N = 36
// frames) the two 3x3 convs are 48.9 GFLOP against 39-114 MB of x, out and
// kernels: 0.30 ms at the 3xTF32 tensor-core rate (165 TFLOP/s), 0.73 ms at
// the f32 CUDA-core rate (67 TFLOP/s), against 0.012-0.034 ms of memory
// traffic at 3.35 TB/s. So the design spends its effort on the math: 3xTF32
// mma.sync tiles of 128 x 64 (128 x 96 where only 96 divides the channels)
// on 8 warps, two blocks per SM, fed by a 3-stage cp.async ring (igemm.cuh).
// a1 and b1 sit in shared memory for the in-place affine.
//
// mid stays in device memory: its round trip is 14-113 MB (4-34 us at
// 3.35 TB/s), small beside the 0.30 ms bound, and one image of mid at
// 8x8x768 with its halo is 307 KB, more than a block's 227 KB of shared memory.
//
// bf16 variant (gblock_conv1_bf16 / gblock_conv2_bf16), what the TPU kernel
// computes given bf16 operands: bf16 x, kernels and out; the affines (a1, b1,
// a2, b2, b_out) stay f32, as pallas_gblock.py builds its (5, C) affine.
// relu(a1 * x + b1) is computed in f32 and rounded to bf16 as it enters
// conv1; conv1's epilogue stores mid = bf16(relu(a2 * acc + b2)), the value
// conv2 rounds it to on entry anyway, so mid costs half the bytes and gives
// the same bits; sums are f32 and out is rounded once.
//
// What bounds it on an H100: arithmetic. At N = 288 frames the two convs are
// 391 GFLOP, 0.40 ms at the bf16 tensor-core rate (989 TFLOP/s), against
// 0.07-0.27 ms for their bytes; at N = 36, 49 GFLOP (0.05 ms). So the design
// is Hopper's, wgmma fed by TMA (halo_conv.cuh, hopper.cuh):
// - a persistent grid (one 384-thread block per SM) walks (128-pixel,
//   BN-channel) output tiles, BN = 96, 192 or 256 picked per layer so the
//   tiles fill the SMs in whole waves;
// - a producer warp issues every copy: per 64-channel chunk one 10x10 halo
//   box per consumer, per (chunk, tap) one K-major tile of the OHWI weights
//   into a multi-stage ring; mbarriers carry the arrivals (TMA complete_tx)
//   and the releases; setmaxnreg leaves the producer warpgroup 40 registers
//   and gives the consumers 232;
// - two consumer warpgroups, each one 8x8 patch (64 rows) by BN, gather A
//   with ldmatrix at each tap's shifted offset and issue wgmma with A from
//   registers; conv1 first applies the affine to each landed halo box in
//   place, in-image pixels only, once for all nine taps;
// - the 1x1 shortcut is nkc more groups of conv2's accumulator (each box's
//   centre tap against the shortcut kernel), the identity an epilogue add;
// - the epilogue stores bf16 pairs straight from the accumulators (the
//   per-channel constants from shared memory) while the producer already
//   loads the block's next tile.
// The tensor cores add into the f32 accumulators directly (no per-K-tile
// round-to-nearest pass as in the f32 kernels): their truncation over
// K = 6912 stays far below one bf16 ulp of the output, the tolerance.

#include "halo_conv.cuh"

namespace dgmr {

struct GBlockArgs {
  const float* x;
  const float* mid_in;
  const float* k1;
  const float* k2;
  const float* ksc;
  const float* a1;
  const float* b1;
  const float* a2;
  const float* b2;
  const float* b_out;
  float* mid;
  float* out;
  int use_sc_conv;
  int N, H, W, Cin, Cout;
};

// Two blocks per SM (at most 128 registers a thread) hide the ring's latency.
template <class Cfg, int VEC>
__global__ void __launch_bounds__(Cfg::THREADS, 2) gblock_conv1_kernel(GBlockArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int M = p.N * p.H * p.W;
  const int C = p.Cin;
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * Cfg::BN;
  float* scale = smem + Cfg::SMEM_BYTES / 4;  // a1, b1 behind the ring
  float* shift = scale + C;
  for (int c = threadIdx.x; c < C; c += Cfg::THREADS) {
    scale[c] = p.a1[c];
    shift[c] = p.b1[c];
  }
  __syncthreads();
  float acc[Cfg::MT][Cfg::NT][4] = {};
  const ConvIn op{p.x, p.k1, scale, shift, p.H, p.W, C, C};
  conv_tile<Cfg, 3, VEC, true>(acc, smem, op, M, m0, n0, 0, cdiv(9 * C, Cfg::BK));
  float a2[Cfg::NT * 4], b2[Cfg::NT * 4];
  epilogue<Cfg>(
      acc, m0, n0,
      [&](int j, int m, int n) {
        a2[j] = n < C ? p.a2[n] : 0.f;
        b2[j] = n < C ? p.b2[n] : 0.f;
      },
      [&](int j, int m, int n, float v) {
        if (m < M && n < C) p.mid[(size_t)m * C + n] = fmaxf(fmaf(a2[j], v, b2[j]), 0.f);
      });
}

template <class Cfg, int VEC>
__global__ void __launch_bounds__(Cfg::THREADS, 2) gblock_conv2_kernel(GBlockArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int M = p.N * p.H * p.W;
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * Cfg::BN;
  float acc[Cfg::MT][Cfg::NT][4] = {};
  const ConvIn op{p.mid_in, p.k2, nullptr, nullptr, p.H, p.W, p.Cin, p.Cout};
  conv_tile<Cfg, 3, VEC, false>(acc, smem, op, M, m0, n0, 0, cdiv(9 * p.Cin, Cfg::BK));
  if (p.use_sc_conv) {  // uniform across the grid, so the barriers inside stay uniform
    const ConvIn sc{p.x, p.ksc, nullptr, nullptr, p.H, p.W, p.Cin, p.Cout};
    conv_tile<Cfg, 1, VEC, false>(acc, smem, sc, M, m0, n0, 0, cdiv(p.Cin, Cfg::BK));
  }
  float add[Cfg::NT * 4];
  epilogue<Cfg>(
      acc, m0, n0,
      [&](int j, int m, int n) {
        const bool ok = m < M && n < p.Cout;
        add[j] = ok ? p.b_out[n] : 0.f;
        if (ok && !p.use_sc_conv) add[j] += p.x[(size_t)m * p.Cout + n];  // identity: Cin == Cout
      },
      [&](int j, int m, int n, float v) {
        if (m < M && n < p.Cout) p.out[(size_t)m * p.Cout + n] = v + add[j];
      });
}

using Mid = TileCfg<128, 96, 2, 4>;
using Narrow = TileCfg<128, 64, 4, 2>;

template <class Cfg, int VEC>
cudaError_t launch_conv(bool second, const GBlockArgs& p, int nout, cudaStream_t stream) {
  auto kernel = second ? gblock_conv2_kernel<Cfg, VEC> : gblock_conv1_kernel<Cfg, VEC>;
  const int smem = Cfg::SMEM_BYTES + (second ? 0 : 2 * p.Cin * (int)sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(p.N * p.H * p.W, Cfg::BM), cdiv(nout, Cfg::BN));
  kernel<<<grid, Cfg::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_vec(bool second, const GBlockArgs& p, int nout, cudaStream_t stream) {
  // 128 x 64 tiles; 128 x 96 where 64 leaves a third of a tile idle and 96
  // divides the channels (the 64^2 x 96 level).
  if (nout % Narrow::BN != 0 && nout % Mid::BN == 0)
    return launch_conv<Mid, VEC>(second, p, nout, stream);
  return launch_conv<Narrow, VEC>(second, p, nout, stream);
}

cudaError_t launch(bool second, const GBlockArgs& p, cudaStream_t stream) {
  const int nout = second ? p.Cout : p.Cin;
  const bool vec = p.Cin % 4 == 0 && nout % 4 == 0 && aligned16(p.x) && aligned16(p.mid_in) &&
                   aligned16(p.k1) && aligned16(p.k2) && aligned16(p.ksc);
  return vec ? launch_vec<4>(second, p, nout, stream) : launch_vec<1>(second, p, nout, stream);
}


// ---------------------------------------------------------------------------
// bf16 variant: wgmma + TMA.

struct GBlockBfArgs {
  const uint16_t* x;  // (N, H, W, Cin) bf16: the identity shortcut's addend
  const float* a1;
  const float* b1;
  const float* a2;
  const float* b2;
  const float* b_out;
  uint16_t* dst;  // conv1: mid (N, H, W, Cin); conv2: out (N, H, W, Nout)
  int use_sc_conv;
  int N, H, W, Cin, Nout;  // channel counts are multiples of 8
  int b_stages;            // B ring depth
};

constexpr int kGbConsumers = 2;                       // warpgroups, one 8x8 patch each
constexpr int kGbThreads = 128 * (kGbConsumers + 1);  // + the producer warpgroup
constexpr int kGbAStages = 2;                         // halo boxes per consumer
constexpr int kGbMaxStages = 8;

// Per-channel f32 constants in shared memory: conv1's a1 and b1 (zero past
// Cin up to whole chunks) and the epilogue's a2 and b2; conv2's b_out.
__host__ __device__ inline int gb_const_bytes(bool conv1, int cin, int nout) {
  const int kc = cdiv(cin, kChunk) * kChunk, no = cdiv(nout, kChunk) * kChunk;
  return cdiv((conv1 ? 2 * kc + 2 * no : no) * 4, 1024) * 1024;
}

// Shared memory before the B ring: alignment slack, barriers, constants, halo boxes.
inline int gb_fixed_bytes(bool conv1, int cin, int nout) {
  return 2048 + gb_const_bytes(conv1, cin, nout) + kGbConsumers * kGbAStages * kBoxSlot;
}

// conv1's A: relu(a1 * x + b1) in f32, rounded to bf16, applied once to a
// landed halo box in place (every tap reads it), by the consumer
// warpgroup's 128 threads, 16 bytes at a time; in-image pixels only
// (zero-filled ones stay 0: SAME padding applies after the affine). Pixel p
// of the box holds logical chunk j of its 64 channels at chunk j ^ (p % 8).
__device__ __forceinline__ void affine_box(uint8_t* box, const float* scale, const float* shift,
                                           int kc, int n, int y0, int x0, const GBlockBfArgs& p,
                                           int tid) {
  for (int idx = tid; idx < kHalo * kHalo * 8; idx += 128) {
    const int px = idx >> 3;
    const int yy = y0 - 1 + px / kHalo, xx = x0 - 1 + px % kHalo;
    if (n >= p.N || yy < 0 || yy >= p.H || xx < 0 || xx >= p.W) continue;
    const int c = kc * kChunk + 8 * ((idx & 7) ^ (px & 7));
    uint4* q = reinterpret_cast<uint4*>(box + idx * 16);
    uint32_t v[4] = {q->x, q->y, q->z, q->w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ce = c + 2 * e;
      v[e] = bf16x2(fmaxf(fmaf(scale[ce], bf16_lo(v[e]), shift[ce]), 0.f),
                    fmaxf(fmaf(scale[ce + 1], bf16_hi(v[e]), shift[ce + 1]), 0.f));
    }
    *q = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// One launch of conv1 (CONV1) or conv2. Maps: a (x or mid, halo boxes), w
// (k1 or k2, OHWI), and for conv2's shortcut conv x (halo boxes) and ksc.
template <int BN, bool CONV1>
__device__ __forceinline__ void gblock_bf16_body(const CUtensorMap& a_map, const CUtensorMap& w_map,
                                                 const CUtensorMap& x_map,
                                                 const CUtensorMap& sc_map,
                                                 const GBlockBfArgs& p) {
  constexpr int kBTile = BN * 128;
  extern __shared__ __align__(1024) uint8_t gb_smem[];
  uint8_t* base = gb_smem + ((1024 - (smem_u32(gb_smem) & 1023)) & 1023);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(base);  // [consumer * kGbAStages + slot]
  uint64_t* a_empty = a_full + kGbConsumers * kGbAStages;
  uint64_t* b_full = a_empty + kGbConsumers * kGbAStages;  // [slot]
  uint64_t* b_empty = b_full + kGbMaxStages;
  const int nkc = cdiv(p.Cin, kChunk);
  const int no = cdiv(p.Nout, kChunk) * kChunk;
  float* scale = reinterpret_cast<float*>(base + 1024);   // conv1: a1
  float* shift = scale + (CONV1 ? nkc * kChunk : 0);      // conv1: b1
  float* emul = shift + (CONV1 ? nkc * kChunk : 0);       // conv1: a2
  float* eadd = emul + (CONV1 ? no : 0);                  // conv1: b2; conv2: b_out
  uint8_t* boxes = base + 1024 + gb_const_bytes(CONV1, p.Cin, p.Nout);
  uint8_t* ring = boxes + kGbConsumers * kGbAStages * kBoxSlot;
  const int stages = p.b_stages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kGbConsumers * kGbAStages; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], 4);  // each warp of the consumer, after its last ldmatrix
    }
    for (int i = 0; i < stages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 4 * kGbConsumers);  // each consumer warp, after its wgmma retired
    }
    mbar_init_fence();
  }
  if (CONV1) {
    for (int c = threadIdx.x; c < nkc * kChunk; c += kGbThreads) {
      scale[c] = c < p.Cin ? p.a1[c] : 0.f;
      shift[c] = c < p.Cin ? p.b1[c] : 0.f;
    }
  }
  for (int c = threadIdx.x; c < no; c += kGbThreads) {
    if (CONV1) emul[c] = c < p.Nout ? p.a2[c] : 0.f;
    eadd[c] = c < p.Nout ? (CONV1 ? p.b2[c] : p.b_out[c]) : 0.f;
  }
  __syncthreads();

  const Patches pat(p.N, p.H, p.W);
  const int n_tiles = cdiv(p.Nout, BN);
  const int tiles = cdiv(pat.count(), kGbConsumers) * n_tiles;
  const int g3 = 9 * nkc;                                           // 3x3 groups
  const int groups = g3 + (!CONV1 && p.use_sc_conv ? nkc : 0);  // + the 1x1 shortcut's
  const int wg = threadIdx.x / 128;

  if (wg == kGbConsumers) {  // producer warpgroup; one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      Ring a, b;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mp = tile / n_tiles;
        const int n0 = (tile - mp * n_tiles) * BN;
        int un[kGbConsumers], uy[kGbConsumers], ux[kGbConsumers];
        for (int w = 0; w < kGbConsumers; ++w) pat.at(kGbConsumers * mp + w, un[w], uy[w], ux[w]);
        for (int g = 0; g < groups; ++g) {
          const bool sc = g >= g3;
          const int kc = sc ? g - g3 : g / 9;
          const int tap = sc ? 0 : g % 9;
          if (sc || tap == 0) {  // a new chunk: one halo box per consumer
            for (int w = 0; w < kGbConsumers; ++w) {
              const int i = w * kGbAStages + a.slot;
              mbar_wait(&a_empty[i], a.phase ^ 1);
              mbar_expect_tx(&a_full[i], kBoxBytes);
              tma_load_4d(boxes + i * kBoxSlot, sc ? &x_map : &a_map, &a_full[i], kc * kChunk,
                          ux[w] - 1, uy[w] - 1, un[w]);
            }
            a.next(kGbAStages);
          }
          mbar_wait(&b_empty[b.slot], b.phase ^ 1);
          mbar_expect_tx(&b_full[b.slot], kBTile);
          tma_load_3d(ring + b.slot * kBTile, sc ? &sc_map : &w_map, &b_full[b.slot], kc * kChunk,
                      tap, n0);
          b.next(stages);
        }
      }
    }
  } else {  // consumer warpgroup wg: patch 2 mp + wg of every tile
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const ALane al(warp, lane);
    const uint32_t boxes_u = smem_u32(boxes);
    const uint32_t ring_u = smem_u32(ring);
    Ring a, b, freed;
    float acc[BN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mp = tile / n_tiles;
      const int n0 = (tile - mp * n_tiles) * BN;
      int n, y0, x0;
      pat.at(kGbConsumers * mp + wg, n, y0, x0);
      auto gather = [&](int g, uint32_t(&fr)[4][4]) {
        const bool sc = g >= g3;
        const int kc = sc ? g - g3 : g / 9;
        const int tap = sc ? 4 : g % 9;  // the shortcut reads the box's centre
        const int i = wg * kGbAStages + a.slot;
        if (sc || tap == 0) {
          mbar_wait(&a_full[i], a.phase);
          if (CONV1) {
            affine_box(boxes + i * kBoxSlot, scale, shift, kc, n, y0, x0, p, threadIdx.x % 128);
            fence_proxy_async_shared();  // before the slot's next TMA fill
            named_barrier(1 + wg, 128);  // the whole box is done before any gather
          }
        }
        mbar_wait(&b_full[b.slot], b.phase);
        load_a(fr, boxes_u + i * kBoxSlot, al, tap);
        if (sc || tap == 8) {  // the chunk's last gather: its box is free
          __syncwarp();
          if (lane == 0) mbar_arrive(&a_empty[i]);
          a.next(kGbAStages);
        }
        const uint32_t tile_b = ring_u + b.slot * kBTile;
        b.next(stages);
        return tile_b;
      };
      auto retired = [&](int) {  // B tiles retire in ring order
        if (lane == 0) mbar_arrive(&b_empty[freed.slot]);
        freed.next(stages);
      };
      run_groups<BN>(acc, groups, gather, retired);

      // Epilogue: thread rows (2 warp + half, lane / 4) of the patch, columns
      // n0 + 8 j + 2 (lane % 4) and + 1.
      size_t row[2];
      bool ok[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int y = y0 + 2 * warp + half;
        const int x = x0 + lane / 4;
        ok[half] = n < p.N && y < p.H && x < p.W;
        row[half] = (((size_t)n * p.H + y) * p.W + x) * p.Nout;
      }
      // 64 columns at a time: the identity shortcut's x loads first, then the
      // stores (interleaved, each load would wait for the store before it:
      // the compiler cannot rule out that they alias).
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 8) {
        uint32_t xv[8][2];
        if (!CONV1 && !p.use_sc_conv) {  // identity: Cin == Nout
#pragma unroll
          for (int jj = 0; jj < 8 && j0 + jj < BN / 8; ++jj) {
            const int col = n0 + 8 * (j0 + jj) + 2 * (lane % 4);
#pragma unroll
            for (int half = 0; half < 2; ++half)
              if (ok[half] && col < p.Nout)
                xv[jj][half] = *reinterpret_cast<const uint32_t*>(p.x + row[half] + col);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8 && j0 + jj < BN / 8; ++jj) {
          const int j = j0 + jj;
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (col >= p.Nout) continue;  // Nout % 8 == 0: col + 1 is in too
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (!ok[half]) continue;
            float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
            if (CONV1) {
              v0 = fmaxf(fmaf(emul[col], v0, eadd[col]), 0.f);
              v1 = fmaxf(fmaf(emul[col + 1], v1, eadd[col + 1]), 0.f);
            } else {
              if (!p.use_sc_conv) {
                v0 += bf16_lo(xv[jj][half]);
                v1 += bf16_hi(xv[jj][half]);
              }
              v0 += eadd[col];
              v1 += eadd[col + 1];
            }
            *reinterpret_cast<uint32_t*>(p.dst + row[half] + col) = bf16x2(v0, v1);
          }
        }
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kGbThreads, 1)
    gblock_conv1_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap k1_map, const GBlockBfArgs p) {
  gblock_bf16_body<BN, true>(x_map, k1_map, x_map, k1_map, p);
}

template <int BN>
__global__ void __launch_bounds__(kGbThreads, 1)
    gblock_conv2_bf16_kernel(const __grid_constant__ CUtensorMap mid_map,
                             const __grid_constant__ CUtensorMap k2_map,
                             const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap ksc_map, const GBlockBfArgs p) {
  gblock_bf16_body<BN, false>(mid_map, k2_map, x_map, ksc_map, p);
}

// The bf16 operands of one launch: the halo-boxed activation a (x or mid) and
// the OHWI weights w (k1 or k2); conv2's shortcut conv also x and ksc.
struct GBlockBfOperands {
  const uint16_t* a;
  const uint16_t* w;
  const uint16_t* x;
  const uint16_t* ksc;
};

template <int BN>
cudaError_t launch_gb_bf16(bool conv1, const GBlockBfOperands& o, GBlockBfArgs p,
                           cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err = halo_map(&maps[0], o.a, p.N, p.H, p.W, p.Cin);
  if (err == cudaSuccess) err = weight_map(&maps[1], o.w, p.Nout, 9, p.Cin, BN);
  if (err != cudaSuccess) return err;
  maps[2] = maps[0];
  maps[3] = maps[1];
  if (!conv1 && p.use_sc_conv) {
    err = halo_map(&maps[2], o.x, p.N, p.H, p.W, p.Cin);
    if (err == cudaSuccess) err = weight_map(&maps[3], o.ksc, p.Nout, 1, p.Cin, BN);
    if (err != cudaSuccess) return err;
  }
  const int fixed = gb_fixed_bytes(conv1, p.Cin, p.Nout);
  p.b_stages = (kSmemLimit - fixed) / (BN * 128);
  if (p.b_stages > kGbMaxStages) p.b_stages = kGbMaxStages;
  if (p.b_stages < 2) return cudaErrorInvalidConfiguration;
  const int smem = fixed + p.b_stages * BN * 128;
  const int tiles = cdiv(Patches(p.N, p.H, p.W).count(), kGbConsumers) * cdiv(p.Nout, BN);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const dim3 grid(tiles < sms ? tiles : sms);
  if (conv1) {
    err = cudaFuncSetAttribute(gblock_conv1_bf16_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gblock_conv1_bf16_kernel<BN><<<grid, kGbThreads, smem, stream>>>(maps[0], maps[1], p);
  } else {
    err = cudaFuncSetAttribute(gblock_conv2_bf16_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gblock_conv2_bf16_kernel<BN><<<grid, kGbThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                                     maps[3], p);
  }
  return cudaGetLastError();
}

// BN for an output of nout channels over `patches` 8x8 patches: the fewest
// whole waves of tiles over the SMs, each tile priced at BN + 64 (its A
// loads and epilogue); ties go to the wider tile.
inline int gb_pick_bn(int patches, int nout) {
  const int widths[3] = {256, 192, 96};
  const int sms = sm_count() > 0 ? sm_count() : 1;
  int best = widths[0];
  long long best_cost = -1;
  for (int bn : widths) {
    const long long waves = cdiv(cdiv(patches, kGbConsumers) * cdiv(nout, bn), sms);
    const long long cost = waves * (bn + 64);
    if (best_cost < 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

cudaError_t launch_bf(bool conv1, const GBlockBfOperands& o, const GBlockBfArgs& p,
                      cudaStream_t stream) {
  if (p.Cin % 8 != 0 || p.Nout % 8 != 0) return cudaErrorInvalidValue;
  if (!aligned16(o.a) || !aligned16(o.w) || !aligned16(o.x) || !aligned16(o.ksc) ||
      !aligned16(p.dst))
    return cudaErrorMisalignedAddress;
  switch (gb_pick_bn(Patches(p.N, p.H, p.W).count(), p.Nout)) {
    case 256: return launch_gb_bf16<256>(conv1, o, p, stream);
    case 192: return launch_gb_bf16<192>(conv1, o, p, stream);
    default: return launch_gb_bf16<96>(conv1, o, p, stream);
  }
}

}  // namespace dgmr

extern "C" {

// Each entry point launches one kernel on `stream` and returns its cudaError_t.
int gblock_conv1_f32(const float* x, const float* k1, const float* a1, const float* b1,
                     const float* a2, const float* b2, float* mid, int N, int H, int W, int C,
                     void* stream) {
  dgmr::GBlockArgs p{};
  p.x = x;
  p.k1 = k1;
  p.a1 = a1;
  p.b1 = b1;
  p.a2 = a2;
  p.b2 = b2;
  p.mid = mid;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = p.Cout = C;
  return static_cast<int>(dgmr::launch(false, p, static_cast<cudaStream_t>(stream)));
}

int gblock_conv2_f32(const float* mid, const float* x, const float* k2, const float* ksc,
                     const float* b_out, float* out, int use_sc_conv, int N, int H, int W,
                     int Cin, int Cout, void* stream) {
  dgmr::GBlockArgs p{};
  p.x = x;
  p.mid_in = mid;
  p.k2 = k2;
  p.ksc = ksc;
  p.b_out = b_out;
  p.out = out;
  p.use_sc_conv = use_sc_conv;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  return static_cast<int>(dgmr::launch(true, p, static_cast<cudaStream_t>(stream)));
}

// bf16 variant: x, k1 bf16 with k1 in OHWI (C, 3, 3, C), affines f32, mid
// bf16 (N, H, W, C); C a multiple of 8, bf16 pointers 16-byte aligned.
int gblock_conv1_bf16(const uint16_t* x, const uint16_t* k1, const float* a1, const float* b1,
                      const float* a2, const float* b2, uint16_t* mid, int N, int H, int W, int C,
                      void* stream) {
  dgmr::GBlockBfArgs p{};
  p.x = x;
  p.a1 = a1;
  p.b1 = b1;
  p.a2 = a2;
  p.b2 = b2;
  p.dst = mid;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = p.Nout = C;
  const dgmr::GBlockBfOperands o{x, k1, x, k1};
  return static_cast<int>(dgmr::launch_bf(true, o, p, static_cast<cudaStream_t>(stream)));
}

// conv2: mid, x, k2 (Cout, 3, 3, Cin) and ksc (Cout, 1, 1, Cin) bf16, both
// OHWI; out bf16 (N, H, W, Cout); Cin and Cout multiples of 8.
int gblock_conv2_bf16(const uint16_t* mid, const uint16_t* x, const uint16_t* k2,
                      const uint16_t* ksc, const float* b_out, uint16_t* out, int use_sc_conv,
                      int N, int H, int W, int Cin, int Cout, void* stream) {
  dgmr::GBlockBfArgs p{};
  p.x = x;
  p.b_out = b_out;
  p.dst = out;
  p.use_sc_conv = use_sc_conv;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Nout = Cout;
  const dgmr::GBlockBfOperands o{mid, k2, x, ksc};
  return static_cast<int>(dgmr::launch_bf(false, o, p, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
