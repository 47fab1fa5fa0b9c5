// Implicit-GEMM convolution mainloop shared by the port's hand-written kernels.
//
// A stride-1 SAME convolution over an NHWC activation is a matrix product
// out[m][n] = sum_k A[m][k] * Wt[k][n] with
//   m = pixel (b, y, x)                     M = B * H * W rows,
//   k = (tap, ci), tap = dy * KS + dx       K = KS * KS * Cin,
//   A[m][k] = in[b, y + dy - KS/2, x + dx - KS/2, ci], 0 outside the image,
// and Wt the HWIO kernel read as a row-major (K, Nout) matrix: HWIO already
// stores (dy, dx, ci) slowest to fastest, so no weight reshuffle is needed.
//
// One block computes a BM x BN tile of `out` with 256 threads, each holding a
// 4 x 4 sub-tile of f32 accumulators. Every K step stages a BM x BK slice of A
// (gathered, zero-padded) and a BK x BN slice of Wt through shared memory, so
// weights of any size stream through in K-tiles; nothing larger than one
// tile ever lives in shared memory. f32 FMA on the CUDA cores: the f32
// parity targets (1e-4 per kernel) leave no room for TF32 tensor cores.

#pragma once

#include <cuda_runtime.h>

namespace dgmr {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // reduction depth staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

struct Tile {
  float a[BK][BM + 1];  // +1 column: the transposed A stores hit distinct banks
  float b[BK][BN];
};

// The four A rows (pixels) this thread gathers; fixed across the K loop.
struct RowCoords {
  int img[4];  // first pixel index of the row's image (b * H * W), -1 past M
  int y[4];
  int x[4];
};

__device__ __forceinline__ void row_coords(RowCoords& rc, int m0, int M, int H, int W) {
  const int hw = H * W;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + threadIdx.x / BK + 16 * j;
    if (m < M) {
      const int b = m / hw;
      const int rem = m - b * hw;
      rc.img[j] = b * hw;
      rc.y[j] = rem / W;
      rc.x[j] = rem - rc.y[j] * W;
    } else {
      rc.img[j] = -1;
      rc.y[j] = 0;
      rc.x[j] = 0;
    }
  }
}

// acc[i][j] += sum_k A[m0 + ty*4 + i][k] * Wt[k][n0 + tx*4 + j], ty/tx = thread / 16, % 16.
// With AFFINE_RELU the gathered value is relu(scale[ci] * v + shift[ci]) inside
// the image and stays 0 outside it: SAME padding applies after the affine.
template <int KS, bool AFFINE_RELU>
__device__ __forceinline__ void conv_mainloop(float (&acc)[4][4], Tile& s, const RowCoords& rc,
                                              const float* __restrict__ in, int H, int W, int Cin,
                                              const float* __restrict__ wgt, int Nout, int n0,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ shift) {
  constexpr int PAD = KS / 2;
  const int t = threadIdx.x;
  const int ki = t % BK;
  const int a_row = t / BK;
  const int b_col = t % BN;
  const int b_row = t / BN;
  const int tx = t % 16;
  const int ty = t / 16;
  const int K = KS * KS * Cin;

  for (int k0 = 0; k0 < K; k0 += BK) {
    float av[4] = {0.f, 0.f, 0.f, 0.f};
    const int k = k0 + ki;
    if (k < K) {
      const int tap = k / Cin;
      const int ci = k - tap * Cin;
      const int dy = tap / KS - PAD;
      const int dx = tap % KS - PAD;
      float sc = 1.f, sh = 0.f;
      if (AFFINE_RELU) {
        sc = scale[ci];
        sh = shift[ci];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int yy = rc.y[j] + dy;
        const int xx = rc.x[j] + dx;
        if (rc.img[j] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W) {
          float v = in[((size_t)rc.img[j] + (size_t)yy * W + xx) * Cin + ci];
          if (AFFINE_RELU) v = fmaxf(fmaf(sc, v, sh), 0.f);
          av[j] = v;
        }
      }
    }
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kb = k0 + b_row + 4 * j;
      const int n = n0 + b_col;
      bv[j] = (kb < K && n < Nout) ? wgt[(size_t)kb * Nout + n] : 0.f;
    }

    __syncthreads();  // every thread is done reading the previous step's tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.a[ki][a_row + 16 * j] = av[j];
      s.b[b_row + 4 * j][b_col] = bv[j];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.a[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.b[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();  // a following mainloop call may overwrite the tile
}

inline dim3 conv_grid(int M, int Nout) {
  // Pixel tiles on x (up to 2^31 - 1 blocks), channel tiles on y.
  return dim3((M + BM - 1) / BM, (Nout + BN - 1) / BN);
}

}  // namespace dgmr
