// The halo-box implicit GEMM shared by the bf16 kernels (gblock_fused.cu,
// gru_rollout.cu): a stride-1 SAME 3x3 convolution over an NHWC bf16
// activation, one warpgroup per 64 output pixels, on wgmma (hopper.cuh).
//
// A warpgroup's 64 output rows are one 8x8 pixel patch of one image. TMA
// loads the patch's 10x10 halo box of 64 channels (one "chunk") into shared
// memory, starting at (x0 - 1, y0 - 1), so the hardware zero-fills the
// out-of-image taps: SAME padding at no cost. Each of the 9 taps reads the
// same box at a shifted offset: ldmatrix takes one row address per lane, so
// the shifted gather is free, and the 128-byte swizzle keeps the eight rows
// of each 8x8 matrix (eight neighbouring pixels) on distinct banks. A group
// is one (chunk, tap): four k16 steps against a K-major B tile of 64 input
// channels of that tap. The A registers are double-buffered across groups
// (run_groups).

#pragma once

#include "hopper.cuh"
#include "igemm.cuh"  // cdiv, sm_count, aligned16

namespace dgmr {

constexpr int kSmemLimit = 232448;                     // a block's shared memory on an H100
constexpr int kChunk = 64;                             // channels per box and per B row
constexpr int kPatch = 8;                              // output patch side (64 pixels)
constexpr int kHalo = kPatch + 2;                      // halo box side
constexpr int kBoxBytes = kHalo * kHalo * kChunk * 2;  // 12800
constexpr int kBoxSlot = (kBoxBytes + 1023) / 1024 * 1024;

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
  __device__ ALane(int warp, int lane) {
    const int r = 16 * warp + (lane & 15);
    p0 = (r >> 3) * kHalo + (r & 7);
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

// NHWC bf16 activation (C % 8 == 0) as a TMA map with the 10x10x64 halo box.
inline cudaError_t halo_map(CUtensorMap* map, const void* ptr, int n, int h, int w, int c) {
  const uint64_t dims[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h, (uint64_t)n};
  const uint64_t strides[3] = {2ull * c, 2ull * c * w, 2ull * c * w * h};
  const uint32_t box[4] = {kChunk, kHalo, kHalo, 1};
  return bf16_tensor_map(map, ptr, 4, dims, strides, box);
}

// OHWI bf16 weights (nout, taps, cin) as a TMA map with boxes of `rows` outputs x 64 channels.
inline cudaError_t weight_map(CUtensorMap* map, const void* ptr, int nout, int taps, int cin,
                              int rows) {
  const uint64_t dims[3] = {(uint64_t)cin, (uint64_t)taps, (uint64_t)nout};
  const uint64_t strides[2] = {2ull * cin, 2ull * cin * taps};
  const uint32_t box[3] = {kChunk, 1, (uint32_t)rows};
  return bf16_tensor_map(map, ptr, 3, dims, strides, box);
}

}  // namespace dgmr
