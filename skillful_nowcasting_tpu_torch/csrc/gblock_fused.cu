// Eval GBlock for Hopper: two launches, conv1 and conv2, each a persistent
// warp-specialized implicit GEMM on wgmma fed by TMA (halo_conv.cuh,
// hopper.cuh), in f32 (3xTF32) and in bf16.
//
// Replaces the Pallas TPU kernel skillful_nowcasting_tpu/ops/pallas_gblock.py:_gblock_kernel:
//
//   out = conv3(relu(a2 * conv3(relu(a1 * x + b1), k1) + b2), k2) + (conv1x1(x, ksc) | x) + b_out
//
// with BN folded into the affines (a1, b1, a2, b2) and spectral norm into the
// kernels; conv1's bias is folded into b2 and conv2's (and the shortcut's)
// into b_out by fold_gblock_variables.
//
//   conv1: relu(a1 * x + b1) applied to each landed halo box of x in place
//          -> conv3(k1) -> epilogue relu(a2 * y + b2) -> mid.
//   conv2: conv3(mid, k2), then the 1x1 shortcut as more groups of the
//          same accumulator (or the identity in the epilogue) + b_out.
//
// SAME zero padding applies after the affine and the ReLU: TMA zero-fills
// the out-of-image taps and only in-image pixels of a box are rewritten to
// relu(a1 * x + b1); padded taps stay 0 (not relu(b1)). mid rows outside the
// image are never gathered (the TPU kernel masks them,
// pallas_gblock.py:108-143): the epilogues store in-image pixels only, so
// a window of rows gives the rows of the whole level, bit for bit.
//
// mid stays in device memory: its round trip is 14-113 MB (f32; 4-34 us at
// 3.35 TB/s), small beside the convs, and one image of mid at 8x8x768 with
// its halo is 307 KB, more than a block's 227 KB of shared memory.
//
// The design, both dtypes (one 384-thread block per SM):
// - a persistent grid walks (128-pixel, BN-channel) output tiles, BN picked
//   per layer so the tiles fill the SMs in whole waves;
// - a producer warp issues every copy: per chunk of input channels one 10x10
//   halo box per consumer, per (chunk, tap) one K-major tile of the OHWI
//   weights into a multi-stage ring; mbarriers carry the arrivals (TMA
//   complete_tx) and the releases; setmaxnreg leaves the producer warpgroup
//   40 registers and gives the consumers 232;
// - two consumer warpgroups, each one 8x8 patch (64 rows) by BN, share each
//   weight tile, gather A with ldmatrix at each tap's shifted offset and
//   issue wgmma with A from registers; conv1 first applies the affine to each
//   landed halo box in place, in-image pixels only, once for all nine taps;
// - the 1x1 shortcut is nkc more groups of conv2's accumulator (each box's
//   centre tap against the shortcut kernel), the identity an epilogue add;
// - the epilogue stores straight from the accumulators (the per-channel
//   constants from shared memory) while the producer already loads the
//   block's next tile.
//
// f32 (gblock_conv1_kernel / gblock_conv2_kernel): 3xTF32 (halo_conv.cuh:
// run_groups_tf32). What bounds it on an H100: arithmetic. At the Sampler's
// shapes the two 3x3 convs are 48.9 GFLOP at N = 36 frames (391 at the tile
// batch's N = 288), 0.30 ms (2.4 ms) at the 3xTF32 rate (165 TFLOP/s),
// against 0.012-0.034 ms of memory traffic at 3.35 TB/s. Boxes hold 32 f32
// channels (the bf16 box's 128 bytes a pixel); the wrapper splits the
// weights once a call into [hi | lo] TF32 halves, so one TMA load brings a
// (chunk, tap)'s B pair and each k8 step is three tf32 wgmma. Each group's
// products start from 0 and are added to the running sum on the CUDA cores
// (round to nearest): the tensor cores truncate their own adds, which over
// K = 6912 drifts toward the 1e-4 bar. BN is 128, 96 or 64: 128 columns
// hold 64 accumulators, 64 group accumulators and 48 A registers (this
// group's hi and lo, the next group's gather) a thread. mid is f32.
//
// bf16 (gblock_conv1_bf16 / gblock_conv2_bf16), what the TPU kernel computes
// given bf16 operands: bf16 x, kernels and out; the affines (a1, b1, a2, b2,
// b_out) stay f32, as pallas_gblock.py builds its (5, C) affine.
// relu(a1 * x + b1) is computed in f32 and rounded to bf16 as it enters
// conv1; conv1's epilogue stores mid = bf16(relu(a2 * acc + b2)), the value
// conv2 rounds it to on entry anyway, so mid costs half the bytes and gives
// the same bits; sums are f32 and out is rounded once. At N = 288 frames the
// two convs take 0.40 ms at the bf16 tensor-core rate (989 TFLOP/s), against
// 0.07-0.27 ms for their bytes; at N = 36, 0.05 ms. Boxes hold 64 channels,
// BN is 256, 192 or 96, and the tensor cores add into the f32 accumulators
// directly (no per-group round-to-nearest pass as in f32): their truncation
// over K = 6912 stays far below one bf16 ulp of the output, the tolerance.

//
// The upsampling variant (upsample_gblock_{a,b}_{f32,bf16}_kernel, the same
// bodies with UP set) runs an eval UpsampleGBlock: in eval, nearest
// upsampling commutes with the per-pixel affine, the ReLU and the 1x1
// shortcut, so the block is a GBlock with the 1x1 shortcut on upsample(x).
// x stays at half resolution in device memory: conv1's halo boxes and the
// shortcut's are 6x6 boxes of x (halo_conv.cuh: kUpHalo), gathered through
// the upsample (load_a_up: upsampled row r reads row r / 2), and the affine
// runs once on each landed low-resolution value. mid and out are at full
// resolution. With UP unset the bodies compile to the GBlock kernels as
// before.

#include "halo_conv.cuh"

namespace dgmr {

// One launch's arguments; T is float (f32) or uint16_t (bf16 bits).
template <class T>
struct GBlockArgs {
  const T* x;  // (N, H, W, Cin): the identity shortcut's addend
  const float* a1;
  const float* b1;
  const float* a2;
  const float* b2;
  const float* b_out;
  T* dst;  // conv1: mid (N, H, W, Cin); conv2: out (N, H, W, Nout)
  int use_sc_conv;
  int N, H, W, Cin, Nout;  // channel counts are multiples of 4 (f32) or 8 (bf16)
  int b_stages;            // B ring depth
};
using GBlockF32Args = GBlockArgs<float>;
using GBlockBfArgs = GBlockArgs<uint16_t>;

// Per-channel f32 constants in shared memory: conv1's a1 and b1 (zero past
// Cin up to whole chunks of `chunk` channels) and the epilogue's a2 and b2;
// conv2's b_out.
__host__ __device__ inline int gb_const_bytes(bool conv1, int cin, int nout, int chunk) {
  const int kc = cdiv(cin, chunk) * chunk, no = cdiv(nout, chunk) * chunk;
  return cdiv((conv1 ? 2 * kc + 2 * no : no) * 4, 1024) * 1024;
}

// ---------------------------------------------------------------------------
// f32 variant: 3xTF32 wgmma + TMA.

// conv1's A: relu(a1 * x + b1), applied once to a landed f32 halo box in
// place (every tap reads it), by the consumer warpgroup's 128 threads, 16
// bytes at a time; in-image pixels only (zero-filled ones stay 0: SAME
// padding applies after the affine). Pixel p of the box holds logical chunk
// j of its 32 channels (4 each) at chunk j ^ (p % 8). The box is SIDE wide,
// its pixel (1, 1) at (y0, x0) of x's (h, w): kHalo, or kUpHalo for the
// upsampling variant's low-resolution x, each value transformed once
// whichever of its four upsampled copies the taps read.
template <int SIDE>
__device__ __forceinline__ void affine_box_f32(uint8_t* box, const float* scale,
                                               const float* shift, int kc, int n, int y0, int x0,
                                               int h, int w, const GBlockF32Args& p, int tid) {
  for (int idx = tid; idx < SIDE * SIDE * 8; idx += 128) {
    const int px = idx >> 3;
    const int yy = y0 - 1 + px / SIDE, xx = x0 - 1 + px % SIDE;
    if (n >= p.N || yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
    const int c = kc * kChunkF32 + 4 * ((idx & 7) ^ (px & 7));
    float4* q = reinterpret_cast<float4*>(box + idx * 16);
    float4 v = *q;
    v.x = fmaxf(fmaf(scale[c], v.x, shift[c]), 0.f);
    v.y = fmaxf(fmaf(scale[c + 1], v.y, shift[c + 1]), 0.f);
    v.z = fmaxf(fmaf(scale[c + 2], v.z, shift[c + 2]), 0.f);
    v.w = fmaxf(fmaf(scale[c + 3], v.w, shift[c + 3]), 0.f);
    *q = v;
  }
}

// One f32 launch of conv1 (CONV1) or conv2. Maps: a (x or mid, halo boxes),
// w (k1 or k2, split OHWI pairs), and for conv2's shortcut conv x and ksc.
// UP, the upsampling variant: x is at half of (p.H, p.W), read through the
// 2x upsample (conv1's boxes and the shortcut's are low-resolution ones), and
// the shortcut is the 1x1 conv.
template <int BN, bool CONV1, bool UP = false>
__device__ __forceinline__ void gblock_f32_body(const CUtensorMap& a_map, const CUtensorMap& w_map,
                                                const CUtensorMap& x_map,
                                                const CUtensorMap& sc_map,
                                                const GBlockF32Args& p) {
  extern __shared__ __align__(1024) uint8_t gb_smem[];
  uint8_t* base = gb_smem + ((1024 - (smem_u32(gb_smem) & 1023)) & 1023);
  const int nkc = cdiv(p.Cin, kChunkF32);
  const int no = cdiv(p.Nout, kChunkF32) * kChunkF32;
  float* scale = reinterpret_cast<float*>(base + 1024);  // conv1: a1
  float* shift = scale + (CONV1 ? nkc * kChunkF32 : 0);  // conv1: b1
  float* emul = shift + (CONV1 ? nkc * kChunkF32 : 0);   // conv1: a2
  float* eadd = emul + (CONV1 ? no : 0);                 // conv1: b2; conv2: b_out
  const F32Pipe pipe(base, base + 1024 + gb_const_bytes(CONV1, p.Cin, p.Nout, kChunkF32), p.b_stages, BN);

  if (threadIdx.x == 0) pipe.init();
  if (CONV1) {
    for (int c = threadIdx.x; c < nkc * kChunkF32; c += kConvThreads) {
      scale[c] = c < p.Cin ? p.a1[c] : 0.f;
      shift[c] = c < p.Cin ? p.b1[c] : 0.f;
    }
  }
  for (int c = threadIdx.x; c < no; c += kConvThreads) {
    if (CONV1) emul[c] = c < p.Nout ? p.a2[c] : 0.f;
    eadd[c] = c < p.Nout ? (CONV1 ? p.b2[c] : p.b_out[c]) : 0.f;
  }
  __syncthreads();

  const Patches pat(p.N, p.H, p.W);
  const int n_tiles = cdiv(p.Nout, BN);
  const int tiles = cdiv(pat.count(), kConsumers) * n_tiles;
  const int g3 = 9 * nkc;                                       // 3x3 groups
  const int groups = g3 + (!CONV1 && p.use_sc_conv ? nkc : 0);  // + the 1x1 shortcut's
  const int wg = threadIdx.x / 128;
  const auto low_res = [](const F32Group& g) { return UP && (CONV1 || g.sc); };

  if (wg == kConsumers) {  // producer warpgroup; one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      Ring a, b;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mp = tile / n_tiles;
        const int n0 = (tile - mp * n_tiles) * BN;
        int un[kConsumers], uy[kConsumers], ux[kConsumers];
        for (int w = 0; w < kConsumers; ++w) pat.at(kConsumers * mp + w, un[w], uy[w], ux[w]);
        pipe.produce<BN>(
            a, b, 0, groups, g3, 0,
            [&](int w, uint8_t* dst, uint64_t* bar, const F32Group& g) {
              const int up = low_res(g) ? 1 : 0;
              tma_load_4d(dst, g.sc ? &x_map : &a_map, bar, g.kc * kChunkF32,
                          (ux[w] >> up) - 1, (uy[w] >> up) - 1, un[w]);
            },
            [&](uint8_t* dst, uint64_t* bar, const F32Group& g) {
              tma_load_4d(dst, g.sc ? &sc_map : &w_map, bar, g.kc * kChunkF32, g.sc ? 0 : g.tap,
                          n0, 0);
            },
            low_res);
      }
    }
  } else {  // consumer warpgroup wg: patch 2 mp + wg of every tile
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const ALane al(warp, lane);
    Ring a, b, freed;
    float acc[BN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mp = tile / n_tiles;
      const int n0 = (tile - mp * n_tiles) * BN;
      int n, y0, x0;
      pat.at(kConsumers * mp + wg, n, y0, x0);
      pipe.consume<BN>(
          acc, a, b, freed, wg, al, lane, 0, groups, g3,
          [&](uint8_t* box, const F32Group& g) {
            if (CONV1 && UP)
              affine_box_f32<kUpHalo>(box, scale, shift, g.kc, n, y0 >> 1, x0 >> 1, p.H >> 1,
                                      p.W >> 1, p, threadIdx.x % 128);
            else if (CONV1)
              affine_box_f32<kHalo>(box, scale, shift, g.kc, n, y0, x0, p.H, p.W, p,
                                    threadIdx.x % 128);
            return CONV1;
          },
          low_res);

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
        float2 xv[8][2];
        if (!CONV1 && !UP && !p.use_sc_conv) {  // identity: Cin == Nout
#pragma unroll
          for (int jj = 0; jj < 8 && j0 + jj < BN / 8; ++jj) {
            const int col = n0 + 8 * (j0 + jj) + 2 * (lane % 4);
#pragma unroll
            for (int half = 0; half < 2; ++half)
              if (ok[half] && col < p.Nout)
                xv[jj][half] = *reinterpret_cast<const float2*>(p.x + row[half] + col);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8 && j0 + jj < BN / 8; ++jj) {
          const int j = j0 + jj;
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (col >= p.Nout) continue;  // Nout % 4 == 0: col + 1 is in too
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (!ok[half]) continue;
            float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
            if (CONV1) {
              v0 = fmaxf(fmaf(emul[col], v0, eadd[col]), 0.f);
              v1 = fmaxf(fmaf(emul[col + 1], v1, eadd[col + 1]), 0.f);
            } else {
              if (!UP && !p.use_sc_conv) {
                v0 += xv[jj][half].x;
                v1 += xv[jj][half].y;
              }
              v0 += eadd[col];
              v1 += eadd[col + 1];
            }
            *reinterpret_cast<float2*>(p.dst + row[half] + col) = make_float2(v0, v1);
          }
        }
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    gblock_conv1_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap k1_map, const GBlockF32Args p) {
  gblock_f32_body<BN, true>(x_map, k1_map, x_map, k1_map, p);
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    gblock_conv2_kernel(const __grid_constant__ CUtensorMap mid_map,
                        const __grid_constant__ CUtensorMap k2_map,
                        const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap ksc_map, const GBlockF32Args p) {
  gblock_f32_body<BN, false>(mid_map, k2_map, x_map, ksc_map, p);
}

// The upsampling variant's conv1 (a) and conv2 (b): x_map's boxes are low-resolution ones.
template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    upsample_gblock_a_f32_kernel(const __grid_constant__ CUtensorMap x_map,
                                 const __grid_constant__ CUtensorMap k1_map,
                                 const GBlockF32Args p) {
  gblock_f32_body<BN, true, true>(x_map, k1_map, x_map, k1_map, p);
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    upsample_gblock_b_f32_kernel(const __grid_constant__ CUtensorMap mid_map,
                                 const __grid_constant__ CUtensorMap k2_map,
                                 const __grid_constant__ CUtensorMap x_map,
                                 const __grid_constant__ CUtensorMap ksc_map,
                                 const GBlockF32Args p) {
  gblock_f32_body<BN, false, true>(mid_map, k2_map, x_map, ksc_map, p);
}

// The operands of one launch: the halo-boxed activation a (x or mid) and the
// OHWI weights w (k1 or k2); conv2's shortcut conv also x and ksc. f32
// weights are split pairs (2, Nout, taps, Cin).
struct GBlockOperands {
  const void* a;
  const void* w;
  const void* x;
  const void* ksc;
};

// ---------------------------------------------------------------------------
// bf16 variant: wgmma + TMA.

// conv1's A: relu(a1 * x + b1) in f32, rounded to bf16, applied once to a
// landed halo box in place (every tap reads it), by the consumer
// warpgroup's 128 threads, 16 bytes at a time; in-image pixels only
// (zero-filled ones stay 0: SAME padding applies after the affine). Pixel p
// of the box holds logical chunk j of its 64 channels at chunk j ^ (p % 8).
// SIDE, (y0, x0) and (h, w) as in affine_box_f32.
template <int SIDE>
__device__ __forceinline__ void affine_box(uint8_t* box, const float* scale, const float* shift,
                                           int kc, int n, int y0, int x0, int h, int w,
                                           const GBlockBfArgs& p, int tid) {
  for (int idx = tid; idx < SIDE * SIDE * 8; idx += 128) {
    const int px = idx >> 3;
    const int yy = y0 - 1 + px / SIDE, xx = x0 - 1 + px % SIDE;
    if (n >= p.N || yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
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
// (k1 or k2, OHWI), and for conv2's shortcut conv x (halo boxes) and ksc. UP
// as in gblock_f32_body.
template <int BN, bool CONV1, bool UP = false>
__device__ __forceinline__ void gblock_bf16_body(const CUtensorMap& a_map, const CUtensorMap& w_map,
                                                 const CUtensorMap& x_map,
                                                 const CUtensorMap& sc_map,
                                                 const GBlockBfArgs& p) {
  constexpr int kBTile = BN * 128;
  extern __shared__ __align__(1024) uint8_t gb_smem[];
  uint8_t* base = gb_smem + ((1024 - (smem_u32(gb_smem) & 1023)) & 1023);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(base);  // [consumer * kAStages + slot]
  uint64_t* a_empty = a_full + kConsumers * kAStages;
  uint64_t* b_full = a_empty + kConsumers * kAStages;  // [slot]
  uint64_t* b_empty = b_full + kMaxBStages;
  const int nkc = cdiv(p.Cin, kChunk);
  const int no = cdiv(p.Nout, kChunk) * kChunk;
  float* scale = reinterpret_cast<float*>(base + 1024);   // conv1: a1
  float* shift = scale + (CONV1 ? nkc * kChunk : 0);      // conv1: b1
  float* emul = shift + (CONV1 ? nkc * kChunk : 0);       // conv1: a2
  float* eadd = emul + (CONV1 ? no : 0);                  // conv1: b2; conv2: b_out
  uint8_t* boxes = base + 1024 + gb_const_bytes(CONV1, p.Cin, p.Nout, kChunk);
  uint8_t* ring = boxes + kConsumers * kAStages * kBoxSlot;
  const int stages = p.b_stages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers * kAStages; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], 4);  // each warp of the consumer, after its last ldmatrix
    }
    for (int i = 0; i < stages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 4 * kConsumers);  // each consumer warp, after its wgmma retired
    }
    mbar_init_fence();
  }
  if (CONV1) {
    for (int c = threadIdx.x; c < nkc * kChunk; c += kConvThreads) {
      scale[c] = c < p.Cin ? p.a1[c] : 0.f;
      shift[c] = c < p.Cin ? p.b1[c] : 0.f;
    }
  }
  for (int c = threadIdx.x; c < no; c += kConvThreads) {
    if (CONV1) emul[c] = c < p.Nout ? p.a2[c] : 0.f;
    eadd[c] = c < p.Nout ? (CONV1 ? p.b2[c] : p.b_out[c]) : 0.f;
  }
  __syncthreads();

  const Patches pat(p.N, p.H, p.W);
  const int n_tiles = cdiv(p.Nout, BN);
  const int tiles = cdiv(pat.count(), kConsumers) * n_tiles;
  const int g3 = 9 * nkc;                                           // 3x3 groups
  const int groups = g3 + (!CONV1 && p.use_sc_conv ? nkc : 0);  // + the 1x1 shortcut's
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {  // producer warpgroup; one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      Ring a, b;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mp = tile / n_tiles;
        const int n0 = (tile - mp * n_tiles) * BN;
        int un[kConsumers], uy[kConsumers], ux[kConsumers];
        for (int w = 0; w < kConsumers; ++w) pat.at(kConsumers * mp + w, un[w], uy[w], ux[w]);
        for (int g = 0; g < groups; ++g) {
          const bool sc = g >= g3;
          const int kc = sc ? g - g3 : g / 9;
          const int tap = sc ? 0 : g % 9;
          if (sc || tap == 0) {  // a new chunk: one halo box per consumer
            const int up = UP && (CONV1 || sc) ? 1 : 0;  // a low-resolution box
            for (int w = 0; w < kConsumers; ++w) {
              const int i = w * kAStages + a.slot;
              mbar_wait(&a_empty[i], a.phase ^ 1);
              mbar_expect_tx(&a_full[i], up ? kUpBoxBytes : kBoxBytes);
              tma_load_4d(boxes + i * kBoxSlot, sc ? &x_map : &a_map, &a_full[i], kc * kChunk,
                          (ux[w] >> up) - 1, (uy[w] >> up) - 1, un[w]);
            }
            a.next(kAStages);
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
      pat.at(kConsumers * mp + wg, n, y0, x0);
      auto gather = [&](int g, uint32_t(&fr)[4][4]) {
        const bool sc = g >= g3;
        const int kc = sc ? g - g3 : g / 9;
        const int tap = sc ? 4 : g % 9;  // the shortcut reads the box's centre
        const int i = wg * kAStages + a.slot;
        if (sc || tap == 0) {
          mbar_wait(&a_full[i], a.phase);
          if (CONV1) {
            if (UP)
              affine_box<kUpHalo>(boxes + i * kBoxSlot, scale, shift, kc, n, y0 >> 1, x0 >> 1,
                                  p.H >> 1, p.W >> 1, p, threadIdx.x % 128);
            else
              affine_box<kHalo>(boxes + i * kBoxSlot, scale, shift, kc, n, y0, x0, p.H, p.W, p,
                                threadIdx.x % 128);
            fence_proxy_async_shared();  // before the slot's next TMA fill
            named_barrier(1 + wg, 128);  // the whole box is done before any gather
          }
        }
        mbar_wait(&b_full[b.slot], b.phase);
        if (UP && (CONV1 || sc))
          load_a_up(fr, boxes_u + i * kBoxSlot, al, tap);
        else
          load_a(fr, boxes_u + i * kBoxSlot, al, tap);
        if (sc || tap == 8) {  // the chunk's last gather: its box is free
          __syncwarp();
          if (lane == 0) mbar_arrive(&a_empty[i]);
          a.next(kAStages);
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
        if (!CONV1 && !UP && !p.use_sc_conv) {  // identity: Cin == Nout
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
              if (!UP && !p.use_sc_conv) {
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
__global__ void __launch_bounds__(kConvThreads, 1)
    gblock_conv1_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap k1_map, const GBlockBfArgs p) {
  gblock_bf16_body<BN, true>(x_map, k1_map, x_map, k1_map, p);
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    gblock_conv2_bf16_kernel(const __grid_constant__ CUtensorMap mid_map,
                             const __grid_constant__ CUtensorMap k2_map,
                             const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap ksc_map, const GBlockBfArgs p) {
  gblock_bf16_body<BN, false>(mid_map, k2_map, x_map, ksc_map, p);
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    upsample_gblock_a_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                                  const __grid_constant__ CUtensorMap k1_map,
                                  const GBlockBfArgs p) {
  gblock_bf16_body<BN, true, true>(x_map, k1_map, x_map, k1_map, p);
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, 1)
    upsample_gblock_b_bf16_kernel(const __grid_constant__ CUtensorMap mid_map,
                                  const __grid_constant__ CUtensorMap k2_map,
                                  const __grid_constant__ CUtensorMap x_map,
                                  const __grid_constant__ CUtensorMap ksc_map,
                                  const GBlockBfArgs p) {
  gblock_bf16_body<BN, false, true>(mid_map, k2_map, x_map, ksc_map, p);
}

// ---------------------------------------------------------------------------
// Launch, both dtypes.

// The width among `widths` for an output of nout channels over `patches`
// 8x8 patches: the fewest whole waves of tiles over the SMs, each tile
// priced at BN + 64 (its A loads and epilogue); ties go to the wider tile.
template <int K>
inline int pick_bn(const int (&widths)[K], int patches, int nout) {
  const int sms = sm_count() > 0 ? sm_count() : 1;
  int best = widths[0];
  long long best_cost = -1;
  for (int bn : widths) {
    const long long waves = cdiv(cdiv(patches, kConsumers) * cdiv(nout, bn), sms);
    const long long cost = waves * (bn + 64);
    if (best_cost < 0 || cost < best_cost) {
      best = bn;
      best_cost = cost;
    }
  }
  return best;
}

// The kernel of one launch: conv1 or conv2, of the GBlock or of its
// upsampling variant (up), for T's dtype.
template <int BN, class T>
auto conv1_kernel(bool up) {
  if constexpr (sizeof(T) == 4)
    return up ? upsample_gblock_a_f32_kernel<BN> : gblock_conv1_kernel<BN>;
  else
    return up ? upsample_gblock_a_bf16_kernel<BN> : gblock_conv1_bf16_kernel<BN>;
}

template <int BN, class T>
auto conv2_kernel(bool up) {
  if constexpr (sizeof(T) == 4)
    return up ? upsample_gblock_b_f32_kernel<BN> : gblock_conv2_kernel<BN>;
  else
    return up ? upsample_gblock_b_bf16_kernel<BN> : gblock_conv2_bf16_kernel<BN>;
}

template <int BN, class T>
cudaError_t launch_gb(bool conv1, bool up, const GBlockOperands& o, GBlockArgs<T> p,
                      cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr CUtensorMapDataType type =
      kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  auto w_map = [&](CUtensorMap* map, const void* w, int taps) {  // f32: [hi | lo] pairs
    return kF32 ? weight_pair_map(map, w, p.Nout, taps, p.Cin, BN)
                : weight_map(map, w, p.Nout, taps, p.Cin, BN);
  };
  // x's map: at the output's resolution, or at half of it with low-resolution boxes.
  auto x_map = [&](CUtensorMap* map, const void* x) {
    return up ? halo_map(map, type, x, p.N, p.H / 2, p.W / 2, p.Cin, kUpHalo)
              : halo_map(map, type, x, p.N, p.H, p.W, p.Cin);
  };
  CUtensorMap maps[4];
  cudaError_t err =
      conv1 ? x_map(&maps[0], o.a) : halo_map(&maps[0], type, o.a, p.N, p.H, p.W, p.Cin);
  if (err == cudaSuccess) err = w_map(&maps[1], o.w, 9);
  if (err != cudaSuccess) return err;
  maps[2] = maps[0];
  maps[3] = maps[1];
  if (!conv1 && p.use_sc_conv) {
    err = x_map(&maps[2], o.x);
    if (err == cudaSuccess) err = w_map(&maps[3], o.ksc, 1);
    if (err != cudaSuccess) return err;
  }
  constexpr int stage = (kF32 ? 2 : 1) * BN * 128;
  const int fixed =
      conv_fixed_bytes(gb_const_bytes(conv1, p.Cin, p.Nout, kF32 ? kChunkF32 : kChunk));
  p.b_stages = ring_stages(fixed, stage);
  if (p.b_stages == 0) return cudaErrorInvalidConfiguration;
  const int smem = fixed + p.b_stages * stage;
  const int tiles = cdiv(Patches(p.N, p.H, p.W).count(), kConsumers) * cdiv(p.Nout, BN);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const dim3 grid(tiles < sms ? tiles : sms);
  if (conv1) {
    const auto kernel = conv1_kernel<BN, T>(up);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kConvThreads, smem, stream>>>(maps[0], maps[1], p);
  } else {
    const auto kernel = conv2_kernel<BN, T>(up);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kConvThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  }
  return cudaGetLastError();
}

// One launch at the width pick_bn takes from the dtype's widths: 128, 96 or
// 64 columns for f32 (whose group accumulator doubles the registers a column
// costs), 256, 192 or 96 for bf16. up: the upsampling variant (p.H and p.W
// even, the 1x1 shortcut).
template <class T>
cudaError_t launch(bool conv1, bool up, const GBlockOperands& o, const GBlockArgs<T>& p,
                   cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int align = kF32 ? 4 : 8;  // channels of TMA's 16-byte strides
  if (p.Cin % align != 0 || p.Nout % align != 0) return cudaErrorInvalidValue;
  if (up && (p.H % 2 != 0 || p.W % 2 != 0 || (!conv1 && !p.use_sc_conv)))
    return cudaErrorInvalidValue;
  if (!aligned16(o.a) || !aligned16(o.w) || !aligned16(o.x) || !aligned16(o.ksc) ||
      !aligned16(p.dst))
    return cudaErrorMisalignedAddress;
  constexpr int widths[3] = {kF32 ? 128 : 256, kF32 ? 96 : 192, kF32 ? 64 : 96};
  switch (pick_bn(widths, Patches(p.N, p.H, p.W).count(), p.Nout)) {
    case widths[0]: return launch_gb<widths[0]>(conv1, up, o, p, stream);
    case widths[1]: return launch_gb<widths[1]>(conv1, up, o, p, stream);
    default: return launch_gb<widths[2]>(conv1, up, o, p, stream);
  }
}

}  // namespace dgmr

extern "C" {

// Each entry point launches one kernel on `stream` and returns its cudaError_t.
// f32: x, affines and mid f32 (N, H, W, C); k1 split into TF32 halves in
// OHWI, (2, C, 3, 3, C) = [hi | lo]; C a multiple of 4, pointers 16-byte
// aligned.
int gblock_conv1_f32(const float* x, const float* k1, const float* a1, const float* b1,
                     const float* a2, const float* b2, float* mid, int N, int H, int W, int C,
                     void* stream) {
  dgmr::GBlockF32Args p{};
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
  const dgmr::GBlockOperands o{x, k1, x, k1};
  return static_cast<int>(dgmr::launch(true, false, o, p, static_cast<cudaStream_t>(stream)));
}

// conv2: mid, x, out f32; k2 (2, Cout, 3, 3, Cin) and ksc (2, Cout, 1, 1, Cin)
// split OHWI pairs; Cin and Cout multiples of 4.
int gblock_conv2_f32(const float* mid, const float* x, const float* k2, const float* ksc,
                     const float* b_out, float* out, int use_sc_conv, int N, int H, int W,
                     int Cin, int Cout, void* stream) {
  dgmr::GBlockF32Args p{};
  p.x = x;
  p.b_out = b_out;
  p.dst = out;
  p.use_sc_conv = use_sc_conv;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Nout = Cout;
  const dgmr::GBlockOperands o{mid, k2, x, ksc};
  return static_cast<int>(dgmr::launch(false, false, o, p, static_cast<cudaStream_t>(stream)));
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
  const dgmr::GBlockOperands o{x, k1, x, k1};
  return static_cast<int>(dgmr::launch(true, false, o, p, static_cast<cudaStream_t>(stream)));
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
  const dgmr::GBlockOperands o{mid, k2, x, ksc};
  return static_cast<int>(dgmr::launch(false, false, o, p, static_cast<cudaStream_t>(stream)));
}

// The upsampling variant, both dtypes: x (N, H, W, Cin) at half the output's
// resolution, read through a 2x nearest upsample in the kernels' loads; mid
// (N, 2H, 2W, Cin) and out (N, 2H, 2W, Cout); the shortcut is the 1x1 conv.
// Kernels, affines and alignment as in the GBlock entry points above.
int upsample_gblock_a_f32(const float* x, const float* k1, const float* a1, const float* b1,
                          const float* a2, const float* b2, float* mid, int N, int H, int W,
                          int C, void* stream) {
  dgmr::GBlockF32Args p{};
  p.x = x;
  p.a1 = a1;
  p.b1 = b1;
  p.a2 = a2;
  p.b2 = b2;
  p.dst = mid;
  p.N = N;
  p.H = 2 * H;
  p.W = 2 * W;
  p.Cin = p.Nout = C;
  const dgmr::GBlockOperands o{x, k1, x, k1};
  return static_cast<int>(dgmr::launch(true, true, o, p, static_cast<cudaStream_t>(stream)));
}

int upsample_gblock_b_f32(const float* mid, const float* x, const float* k2, const float* ksc,
                          const float* b_out, float* out, int N, int H, int W, int Cin, int Cout,
                          void* stream) {
  dgmr::GBlockF32Args p{};
  p.x = x;
  p.b_out = b_out;
  p.dst = out;
  p.use_sc_conv = 1;
  p.N = N;
  p.H = 2 * H;
  p.W = 2 * W;
  p.Cin = Cin;
  p.Nout = Cout;
  const dgmr::GBlockOperands o{mid, k2, x, ksc};
  return static_cast<int>(dgmr::launch(false, true, o, p, static_cast<cudaStream_t>(stream)));
}

int upsample_gblock_a_bf16(const uint16_t* x, const uint16_t* k1, const float* a1,
                           const float* b1, const float* a2, const float* b2, uint16_t* mid,
                           int N, int H, int W, int C, void* stream) {
  dgmr::GBlockBfArgs p{};
  p.x = x;
  p.a1 = a1;
  p.b1 = b1;
  p.a2 = a2;
  p.b2 = b2;
  p.dst = mid;
  p.N = N;
  p.H = 2 * H;
  p.W = 2 * W;
  p.Cin = p.Nout = C;
  const dgmr::GBlockOperands o{x, k1, x, k1};
  return static_cast<int>(dgmr::launch(true, true, o, p, static_cast<cudaStream_t>(stream)));
}

int upsample_gblock_b_bf16(const uint16_t* mid, const uint16_t* x, const uint16_t* k2,
                           const uint16_t* ksc, const float* b_out, uint16_t* out, int N, int H,
                           int W, int Cin, int Cout, void* stream) {
  dgmr::GBlockBfArgs p{};
  p.x = x;
  p.b_out = b_out;
  p.dst = out;
  p.use_sc_conv = 1;
  p.N = N;
  p.H = 2 * H;
  p.W = 2 * W;
  p.Cin = Cin;
  p.Nout = Cout;
  const dgmr::GBlockOperands o{mid, k2, x, ksc};
  return static_cast<int>(dgmr::launch(false, true, o, p, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
