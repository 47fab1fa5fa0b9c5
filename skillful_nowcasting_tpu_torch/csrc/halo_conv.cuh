// The halo-box implicit GEMM shared by the port's kernels (gblock_fused.cu,
// gru_rollout.cu): a stride-1 SAME 3x3 convolution over an NHWC activation,
// one warpgroup per 64 output pixels, on wgmma (hopper.cuh). bf16 operands
// take bf16 wgmma; f32 operands take 3xTF32 on tf32 wgmma.
//
// A warpgroup's 64 output rows are one 8x8 pixel patch of one image. TMA
// loads the patch's 10x10 halo box of one "chunk" of channels (64 bf16 or 32
// f32: 128 bytes a pixel either way) into shared memory, starting at
// (x0 - 1, y0 - 1), so the hardware zero-fills the out-of-image taps: SAME
// padding at no cost. Each of the 9 taps reads the same box at a shifted
// offset: ldmatrix takes one row address per lane, so the shifted gather is
// free, and the 128-byte swizzle keeps the eight rows of each 8x8 matrix
// (eight neighbouring pixels) on distinct banks. A group is one (chunk,
// tap): four k16 (bf16) or k8 (tf32) steps against a K-major B tile of that
// chunk's input channels of that tap.
//
// bf16: the A registers are double-buffered across groups (run_groups) and
// the tensor cores accumulate straight into the f32 accumulators.
//
// f32 (3xTF32, run_groups_tf32): each A fragment is split in registers
// into a TF32 high part and a TF32 remainder (split_tf32), and the weights
// come pre-split by the wrapper as a [hi | lo] pair of tiles, so each k8
// step is three wgmma (lo * hi, hi * lo, hi * hi; lo * lo, ~2^-20 of a
// product, is dropped). The tensor cores truncate when they add into an f32
// accumulator: summed straight into one accumulator over K = 6912 (conv2 of
// the 768-channel GBlock) that bias reached 2.2e-4 in the mma.sync kernels
// this design replaced, against a bar of 1e-4. So each group's twelve
// products start from 0 in a group accumulator (scale-d 0 on the first) and
// reach the running sum through one IEEE round-to-nearest add on the CUDA
// cores per group (32 channels of one tap: the same rounding as those
// kernels' 32-deep K-tiles). The group accumulator costs BN / 2 registers
// and a wait on each group; group g + 1's gather overlaps group g's wgmma,
// and the block's second consumer warpgroup keeps the tensor cores busy
// across the wait.

#pragma once

#include "hopper.cuh"

namespace dgmr {

constexpr int kSmemLimit = 232448;                     // a block's shared memory on an H100
constexpr int kChunk = 64;                             // bf16 channels per box and per B row
constexpr int kChunkF32 = 32;                          // f32 channels per box and per B row
constexpr int kPatch = 8;                              // output patch side (64 pixels)
constexpr int kHalo = kPatch + 2;                      // halo box side
constexpr int kBoxBytes = kHalo * kHalo * 128;         // 12800: 128 bytes a pixel
constexpr int kBoxSlot = (kBoxBytes + 1023) / 1024 * 1024;
// A GBlock's upsampling variant reads its input at half the output's
// resolution through a 2x nearest upsample: the 10x10 halo of an 8x8 output
// patch at (y0, x0) (both even) covers low-resolution rows and columns y0 / 2
// - 1 .. y0 / 2 + 4, a 6x6 box, loaded from (x0 / 2 - 1, y0 / 2 - 1) so TMA
// zero-fills the taps outside the image at either resolution.
constexpr int kUpHalo = kPatch / 2 + 2;
constexpr int kUpBoxBytes = kUpHalo * kUpHalo * 128;  // 4608

// The 8x8 patches of an (N, H, W) activation, image-major.
struct Patches {
  int N, H, W, py, px;
  __host__ __device__ Patches(int n, int h, int w)
      : N(n), H(h), W(w), py(cdiv(h, kPatch)), px(cdiv(w, kPatch)) {}
  __host__ __device__ int count() const { return N * py * px; }
  // Image and top-left pixel of patch u (n == N past the last patch: an all-zero box).
  __device__ void at(int u, int& n, int& y0, int& x0) const {
    n = u / (py * px);
    const int r = u - n * py * px;
    y0 = (r / px) * kPatch;
    x0 = (r % px) * kPatch;
  }
};

// This lane's ldmatrix row in its warpgroup's 64 (warp w: rows 16 w .. 16 w + 15)
// as a halo-box pixel at tap (0, 0), and which 8 channels of a k16 step it addresses.
struct ALane {
  int p0, hi;
  int py, px;  // the row as a patch pixel
  __device__ ALane(int warp, int lane) {
    const int r = 16 * warp + (lane & 15);
    py = r >> 3;
    px = r & 7;
    p0 = py * kHalo + px;
    hi = lane >> 4;
  }
};

// A fragments of the four k16 steps of tap `tap` (dy = tap / 3, dx = tap % 3)
// from the halo box at shared address `box`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t box, const ALane& l,
                                       int tap) {
  const int p = l.p0 + (tap / 3) * kHalo + tap % 3;
  const uint32_t row = box + p * 128;
#pragma unroll
  for (int s = 0; s < 4; ++s) ldmatrix_x4(a[s], row + (((2 * s + l.hi) ^ (p & 7)) << 4));
}

// The same from a low-resolution box (kUpHalo wide): halo pixel (fy, fx) of
// the upsampled input is box pixel ((fy + 1) / 2, (fx + 1) / 2). Up to two
// lanes of a matrix read one pixel, which the shared memory broadcasts.
__device__ __forceinline__ void load_a_up(uint32_t (&a)[4][4], uint32_t box, const ALane& l,
                                          int tap) {
  const int p = ((l.py + tap / 3 + 1) >> 1) * kUpHalo + ((l.px + tap % 3 + 1) >> 1);
  const uint32_t row = box + p * 128;
#pragma unroll
  for (int s = 0; s < 4; ++s) ldmatrix_x4(a[s], row + (((2 * s + l.hi) ^ (p & 7)) << 4));
}

// acc += the group's 64 x 64 A by the B tile at shared address `b` (N rows
// of 64 channels). Commits one wgmma group.
template <int N>
__device__ __forceinline__ void mma_group(float (&acc)[N / 2], const uint32_t (&a)[4][4],
                                          uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) Wgmma<N>::mma(acc, a[s], desc_k_sw128(b + 32 * s), 1);
  wgmma_commit();
}

template <int I>
struct Index {
  static constexpr int value = I;
};

// acc = the sum of `groups` groups. gather(g, fr) waits for group g's
// operands, gathers its A into fr and returns its B tile's shared address;
// retired(g) runs once group g's wgmma has completed (its B tile is free).
// The A registers alternate between two buffers: group g's gather overlaps
// group g - 1's wgmma, and wgmma_wait<1> after each commit retires g - 1,
// whose buffer group g + 1 then reuses.
template <int N, class Gather, class Retired>
__device__ __forceinline__ void run_groups(float (&acc)[N / 2], int groups, Gather&& gather,
                                           Retired&& retired) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  uint32_t fa[2][4][4];
  auto step = [&](int g, auto buf) {
    constexpr int b = decltype(buf)::value;
    const uint32_t tile = gather(g, fa[b]);
    mma_group<N>(acc, fa[b], tile);
    wgmma_wait<1>();
    if (g > 0) retired(g - 1);
  };
  int g = 0;
  for (; g + 1 < groups; g += 2) {
    step(g, Index<0>{});
    step(g + 1, Index<1>{});
  }
  if (g < groups) step(g, Index<0>{});
  wgmma_wait<0>();
  if (groups > 0) retired(groups - 1);
  fence_operands(acc);
}

// One ring of shared-memory slots: slot index and the parity of its current use.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// acc = the sum of `groups` groups in 3xTF32, each from a fresh group
// accumulator added to acc on the CUDA cores. gather(g, a) waits for group
// g's operands, gathers its A fragments into a and returns the shared
// address of its B pair ([hi | lo] tiles of N rows of 32 channels);
// retired(g) runs once group g's wgmma has completed (its B pair is free).
// Group g + 1's gather overlaps group g's wgmma; its split into TF32 halves
// waits for g's registers (at N = 128 a second pair of halves would spill).
template <int N, class Gather, class Retired>
__device__ __forceinline__ void run_groups_tf32(float (&acc)[N / 2], int groups, Gather&& gather,
                                                Retired&& retired) {
  float part[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t raw[4][4], hi[4][4], lo[4][4];
  uint32_t tile = groups > 0 ? gather(0, raw) : 0;
  for (int g = 0; g < groups; ++g) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(raw[s][r], hi[s][r], lo[s][r]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t b_hi = tile + 32 * s, b_lo = b_hi + N * 128;
      WgmmaTf32<N>::mma(part, lo[s], desc_k_sw128(b_hi), s > 0);
      WgmmaTf32<N>::mma(part, hi[s], desc_k_sw128(b_lo), 1);
      WgmmaTf32<N>::mma(part, hi[s], desc_k_sw128(b_hi), 1);
    }
    wgmma_commit();
    const uint32_t next = g + 1 < groups ? gather(g + 1, raw) : 0;
    wgmma_wait<0>();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
    retired(g);
    tile = next;
  }
}

// Group g of an f32 conv's K walk: the 9 taps of each 32-channel chunk, then
// (g >= g3: a GBlock's 1x1 shortcut) one group per chunk at the box's centre.
// A unit walks groups [g0, g1): a halo box lands at its first group and at
// each chunk's first tap, and is released after its last.
struct F32Group {
  int kc, tap;
  bool sc, first, last;
  __device__ F32Group(int g, int g0, int g1, int g3) {
    sc = g >= g3;
    kc = sc ? g - g3 : g / 9;
    tap = sc ? 4 : g % 9;
    first = sc || tap == 0 || g == g0;
    last = sc || tap == 8 || g == g1 - 1;
  }
};

// Which groups' boxes are low-resolution ones (kUpHalo wide, read through
// the 2x upsample): none but in a GBlock's upsampling variant.
struct FullRes {
  __device__ constexpr bool operator()(const F32Group&) const { return false; }
};

// A conv block: two consumer warpgroups and a producer warpgroup.
constexpr int kConsumers = 2;  // warpgroups, one 8x8 patch each
constexpr int kConvThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kAStages = 2;  // halo boxes per consumer
constexpr int kMaxBStages = 8;

// An f32 conv block's shared-memory pipeline: per consumer warpgroup a ring
// of kAStages halo boxes, and one ring of `stages` B pairs both consumers
// read (their two patches share the output columns). A slot holds the
// widest pair the block loads (slot_bytes); each unit's pair is BN wide.
struct F32Pipe {
  uint64_t* a_full;  // [consumer * kAStages + slot]
  uint64_t* a_empty;
  uint64_t* b_full;  // [slot]
  uint64_t* b_empty;
  uint8_t* boxes;
  uint8_t* ring;
  int stages;
  int slot_bytes;  // the widest B pair: 2 BN 128

  // Lay the pipeline out at `base` (1024-aligned): barriers in its first
  // 1024 bytes, the boxes at `boxes_at`, then the B ring.
  __device__ F32Pipe(uint8_t* base, uint8_t* boxes_at, int b_stages, int max_bn)
      : a_full(reinterpret_cast<uint64_t*>(base)),
        a_empty(a_full + kConsumers * kAStages),
        b_full(a_empty + kConsumers * kAStages),
        b_empty(b_full + kMaxBStages),
        boxes(boxes_at),
        ring(boxes_at + kConsumers * kAStages * kBoxSlot),
        stages(b_stages),
        slot_bytes(2 * max_bn * 128) {}

  // One thread, before __syncthreads.
  __device__ void init() const {
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

  // Producer (one thread): one group's B pair into the next ring slot.
  template <int BN, class LoadB>
  __device__ void produce_b(Ring& b, const F32Group& grp, LoadB&& load_b) const {
    mbar_wait(&b_empty[b.slot], b.phase ^ 1);
    mbar_expect_tx(&b_full[b.slot], 2 * BN * 128);
    load_b(ring + b.slot * slot_bytes, &b_full[b.slot], grp);
    b.next(stages);
  }

  // Producer (one thread): the TMA loads of groups [g0, g1) for both
  // consumers, but the B pairs of the first `skip` groups (already issued
  // ahead, as they do not depend on the boxes' data). load_box(w, dst, bar,
  // group) issues consumer w's halo box, load_b(dst, bar, group) the B pair;
  // low_res(group) says the box is a low-resolution one.
  template <int BN, class LoadBox, class LoadB, class LowRes = FullRes>
  __device__ void produce(Ring& a, Ring& b, int g0, int g1, int g3, int skip,
                          LoadBox&& load_box, LoadB&& load_b, LowRes low_res = {}) const {
    for (int g = g0; g < g1; ++g) {
      const F32Group grp(g, g0, g1, g3);
      if (grp.first) {
        for (int w = 0; w < kConsumers; ++w) {
          const int i = w * kAStages + a.slot;
          mbar_wait(&a_empty[i], a.phase ^ 1);
          mbar_expect_tx(&a_full[i], low_res(grp) ? kUpBoxBytes : kBoxBytes);
          load_box(w, boxes + i * kBoxSlot, &a_full[i], grp);
        }
        a.next(kAStages);
      }
      if (g - g0 >= skip) produce_b<BN>(b, grp, load_b);
    }
  }

  // Consumer warpgroup wg: acc = its patch's sum over groups [g0, g1).
  // on_box(box, group) runs on each landed box, by the warpgroup's 128
  // threads, before any gather from it (a GBlock's conv1 affine); it returns
  // whether it wrote the box. low_res(group) as in produce.
  template <int BN, class OnBox, class LowRes = FullRes>
  __device__ void consume(float (&acc)[BN / 2], Ring& a, Ring& b, Ring& freed, int wg,
                          const ALane& al, int lane, int g0, int g1, int g3,
                          OnBox&& on_box, LowRes low_res = {}) const {
    const uint32_t boxes_u = smem_u32(boxes), ring_u = smem_u32(ring);
    auto gather = [&](int k, uint32_t(&fr)[4][4]) {
      const F32Group grp(g0 + k, g0, g1, g3);
      const int i = wg * kAStages + a.slot;
      if (grp.first) {
        mbar_wait(&a_full[i], a.phase);
        if (on_box(boxes + i * kBoxSlot, grp)) {
          fence_proxy_async_shared();  // before the slot's next TMA fill
          named_barrier(1 + wg, 128);  // the whole box is done before any gather
        }
      }
      mbar_wait(&b_full[b.slot], b.phase);
      if (low_res(grp))  // f32: 4 k8 steps
        load_a_up(fr, boxes_u + i * kBoxSlot, al, grp.tap);
      else
        load_a(fr, boxes_u + i * kBoxSlot, al, grp.tap);
      if (grp.last) {  // its last gather: the box is free
        __syncwarp();
        if (lane == 0) mbar_arrive(&a_empty[i]);
        a.next(kAStages);
      }
      const uint32_t pair = ring_u + b.slot * slot_bytes;
      b.next(stages);
      return pair;
    };
    auto retired = [&](int) {  // B pairs retire in ring order
      if (lane == 0) mbar_arrive(&b_empty[freed.slot]);
      freed.next(stages);
    };
    run_groups_tf32<BN>(acc, g1 - g0, gather, retired);
  }
};

// Bytes of a conv block's shared memory before its B ring: alignment slack,
// barriers, `extra` bytes of constants, the boxes.
inline int conv_fixed_bytes(int extra) {
  return 2048 + extra + kConsumers * kAStages * kBoxSlot;
}

// B ring depth for stages of `stage` bytes after `fixed`, or 0 when two do not fit.
inline int ring_stages(int fixed, int stage) {
  int s = (kSmemLimit - fixed) / stage;
  s = s < kMaxBStages ? s : kMaxBStages;
  return s >= 2 ? s : 0;
}

// NHWC activation (bf16: C % 8 == 0; f32: C % 4 == 0) as a TMA map with the
// 10x10 halo box of one chunk (or the side x side box of a low-resolution input).
inline cudaError_t halo_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int n,
                            int h, int w, int c, int side = kHalo) {
  const uint64_t e = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const uint64_t dims[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h, (uint64_t)n};
  const uint64_t strides[3] = {e * c, e * c * w, e * c * w * h};
  const uint32_t box[4] = {(uint32_t)(128 / e), (uint32_t)side, (uint32_t)side, 1};
  return tensor_map(map, type, ptr, 4, dims, strides, box);
}

// (T, N, H, W, C) states, one step's halo box at a time (the rollouts' out).
inline cudaError_t step_halo_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                                 int n, int h, int w, int c, int t) {
  const uint64_t e = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const uint64_t dims[5] = {(uint64_t)c, (uint64_t)w, (uint64_t)h, (uint64_t)n, (uint64_t)t};
  const uint64_t strides[4] = {e * c, e * c * w, e * c * w * h, e * c * w * h * n};
  const uint32_t box[5] = {(uint32_t)(128 / e), kHalo, kHalo, 1, 1};
  return tensor_map(map, type, ptr, 5, dims, strides, box);
}

// OHWI bf16 weights (nout, taps, cin) as a TMA map with boxes of `rows` outputs x 64 channels.
inline cudaError_t weight_map(CUtensorMap* map, const void* ptr, int nout, int taps, int cin,
                              int rows) {
  const uint64_t dims[3] = {(uint64_t)cin, (uint64_t)taps, (uint64_t)nout};
  const uint64_t strides[2] = {2ull * cin, 2ull * cin * taps};
  const uint32_t box[3] = {kChunk, 1, (uint32_t)rows};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, 3, dims, strides, box);
}

// Split OHWI f32 weights (2, nout, taps, cin), [hi | lo], as a TMA map whose
// box is one B pair: `rows` outputs x 32 channels of one tap, hi then lo.
inline cudaError_t weight_pair_map(CUtensorMap* map, const void* ptr, int nout, int taps,
                                   int cin, int rows) {
  const uint64_t dims[4] = {(uint64_t)cin, (uint64_t)taps, (uint64_t)nout, 2};
  const uint64_t strides[3] = {4ull * cin, 4ull * cin * taps, 4ull * cin * taps * nout};
  const uint32_t box[4] = {kChunkF32, 1, (uint32_t)rows, 2};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 4, dims, strides, box);
}

}  // namespace dgmr
