// Eval GBlock for Hopper, in two launches.
//
// Replaces the Pallas TPU kernel skillful_nowcasting_tpu/ops/pallas_gblock.py:_gblock_kernel:
//
//   out = conv3(relu(a2 * conv3(relu(a1 * x + b1), k1) + b2), k2) + (conv1x1(x, ksc) | x) + b_out
//
// with BN folded into the affines (a1, b1, a2, b2) and spectral norm into the
// kernels; conv1's bias is folded into b2 and conv2's (and the shortcut's)
// into b_out by fold_gblock_variables.
//
//   gblock_conv1: relu(a1 * x + b1) applied while gathering x -> conv3(k1)
//                 -> epilogue relu(a2 * y + b2) -> mid (device memory).
//   gblock_conv2: conv3(mid, k2), then the 1x1 shortcut as more K steps of the
//                 same accumulator (or the identity in the epilogue) + b_out.
//
// SAME zero padding applies after the affine and the ReLU: the gather of
// igemm.cuh applies the affine only to pixels inside the image and leaves
// out-of-image taps at 0 (not relu(b1)); mid rows outside the image are never
// read for the same reason (the TPU kernel masks them, pallas_gblock.py:108-143).
//
// What bounds it: the two 3x3 convs are compute-heavy (K = 9 * 768 at the
// Sampler's 8x8 level) and run on f32 CUDA cores; mid makes one round trip
// through device memory. Keeping mid on chip (one pass over an H-tile with a
// two-row halo, as the TPU kernel does) and tensor-core math are later work.

#include "igemm.cuh"

namespace dgmr {

__global__ void __launch_bounds__(THREADS)
gblock_conv1_kernel(const float* __restrict__ x, const float* __restrict__ k1,
                    const float* __restrict__ a1, const float* __restrict__ b1,
                    const float* __restrict__ a2, const float* __restrict__ b2,
                    float* __restrict__ mid, int N, int H, int W, int C) {
  __shared__ Tile s;
  const int M = N * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  RowCoords rc;
  row_coords(rc, m0, M, H, W);
  float acc[4][4] = {};
  conv_mainloop<3, true>(acc, s, rc, x, H, W, C, k1, C, n0, a1, b1);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= C) continue;
      mid[(size_t)m * C + n] = fmaxf(fmaf(a2[n], acc[i][j], b2[n]), 0.f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gblock_conv2_kernel(const float* __restrict__ mid, const float* __restrict__ x,
                    const float* __restrict__ k2, const float* __restrict__ ksc,
                    const float* __restrict__ b_out, float* __restrict__ out, int use_sc_conv,
                    int N, int H, int W, int Cin, int Cout) {
  __shared__ Tile s;
  const int M = N * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  RowCoords rc;
  row_coords(rc, m0, M, H, W);
  float acc[4][4] = {};
  conv_mainloop<3, false>(acc, s, rc, mid, H, W, Cin, k2, Cout, n0, nullptr, nullptr);
  if (use_sc_conv) {  // uniform across the grid, so the barriers inside stay uniform
    conv_mainloop<1, false>(acc, s, rc, x, H, W, Cin, ksc, Cout, n0, nullptr, nullptr);
  }

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      float v = acc[i][j] + b_out[n];
      if (!use_sc_conv) v += x[(size_t)m * Cout + n];  // identity shortcut: Cin == Cout
      out[(size_t)m * Cout + n] = v;
    }
  }
}

}  // namespace dgmr

extern "C" {

int gblock_conv1_f32(const float* x, const float* k1, const float* a1, const float* b1,
                     const float* a2, const float* b2, float* mid, int N, int H, int W, int C,
                     void* stream) {
  const dim3 grid = dgmr::conv_grid(N * H * W, C);
  dgmr::gblock_conv1_kernel<<<grid, dgmr::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, k1, a1, b1, a2, b2, mid, N, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

int gblock_conv2_f32(const float* mid, const float* x, const float* k2, const float* ksc,
                     const float* b_out, float* out, int use_sc_conv, int N, int H, int W,
                     int Cin, int Cout, void* stream) {
  const dim3 grid = dgmr::conv_grid(N * H * W, Cout);
  dgmr::gblock_conv2_kernel<<<grid, dgmr::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mid, x, k2, ksc, b_out, out, use_sc_conv, N, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
