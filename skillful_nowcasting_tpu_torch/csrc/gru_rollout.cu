// One eval ConvGRU step for Hopper, in two launches; the host loops over t.
//
// Replaces the Pallas TPU kernel skillful_nowcasting_tpu/ops/pallas_gru.py:_gru_kernel.
// That kernel walks a sequential (B, T) grid and keeps h in VMEM scratch for
// all T steps. Blocks on this card run in parallel and in no order, and step
// t + 1 needs every neighbour of step t (and, inside a step, conv3(r * h)
// needs r on a one-pixel halo), so a step is two grid-wide launches:
//
//   gru_gates:  conv3(h, k_ru) -> r = sigmoid(. + gx_r + b_r), u = sigmoid(. + gx_u + b_u);
//               writes r * h and u.
//   gru_update: conv3(r * h, k_c) -> c = relu(. + gx_c + b_c); h' = u * h + (1 - u) * c,
//               written straight into out[t], which is step t + 1's h.
//
// Both are implicit GEMMs (igemm.cuh) with f32 accumulation; the gate math is
// the epilogue. The hidden weights (k_ru is 3*3*384*768*4 B = 10.6 MB at the
// Sampler's bottom level) stream through shared memory in K-tiles.
//
// What bounds it: at small batch each step re-reads the hidden weights from
// L2/HBM and the pixel count per level is small (M = B*64 at 8x8), so few
// blocks run and each step is latency- and launch-bound. Keeping h on chip
// across steps (a persistent or cluster kernel), wgmma and CUDA graphs over
// the step loop are later work.

#include "igemm.cuh"

namespace dgmr {

__global__ void __launch_bounds__(THREADS)
gru_gates_kernel(const float* __restrict__ h, const float* __restrict__ k_ru,
                 const float* __restrict__ gx, const float* __restrict__ bias,
                 float* __restrict__ rh, float* __restrict__ u, int B, int H, int W, int C) {
  __shared__ Tile s;
  const int M = B * H * W;
  const int N2 = 2 * C;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  RowCoords rc;
  row_coords(rc, m0, M, H, W);
  float acc[4][4] = {};
  conv_mainloop<3, false>(acc, s, rc, h, H, W, C, k_ru, N2, n0, nullptr, nullptr);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N2) continue;
      // gx and bias channel order: read [0, C), update [C, 2C), candidate [2C, 3C).
      const float pre = acc[i][j] + gx[(size_t)m * 3 * C + n] + bias[n];
      const float g = 1.f / (1.f + expf(-pre));
      if (n < C) {
        rh[(size_t)m * C + n] = g * h[(size_t)m * C + n];
      } else {
        u[(size_t)m * C + (n - C)] = g;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gru_update_kernel(const float* __restrict__ rh, const float* __restrict__ k_c,
                  const float* __restrict__ gx, const float* __restrict__ bias,
                  const float* __restrict__ u, const float* __restrict__ h,
                  float* __restrict__ h_new, int B, int H, int W, int C) {
  __shared__ Tile s;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  RowCoords rc;
  row_coords(rc, m0, M, H, W);
  float acc[4][4] = {};
  conv_mainloop<3, false>(acc, s, rc, rh, H, W, C, k_c, C, n0, nullptr, nullptr);

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
      const float pre = acc[i][j] + gx[(size_t)m * 3 * C + 2 * C + n] + bias[2 * C + n];
      const float cand = fmaxf(pre, 0.f);
      const size_t o = (size_t)m * C + n;
      const float uu = u[o];
      h_new[o] = uu * h[o] + (1.f - uu) * cand;
    }
  }
}

}  // namespace dgmr

extern "C" {

const char* dgmr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry point launches one kernel on `stream` and returns cudaGetLastError().
int gru_gates_f32(const float* h, const float* k_ru, const float* gx, const float* bias,
                  float* rh, float* u, int B, int H, int W, int C, void* stream) {
  const dim3 grid = dgmr::conv_grid(B * H * W, 2 * C);
  dgmr::gru_gates_kernel<<<grid, dgmr::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      h, k_ru, gx, bias, rh, u, B, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

int gru_update_f32(const float* rh, const float* k_c, const float* gx, const float* bias,
                   const float* u, const float* h, float* h_new, int B, int H, int W, int C,
                   void* stream) {
  const dim3 grid = dgmr::conv_grid(B * H * W, C);
  dgmr::gru_update_kernel<<<grid, dgmr::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rh, k_c, gx, bias, u, h, h_new, B, H, W, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
