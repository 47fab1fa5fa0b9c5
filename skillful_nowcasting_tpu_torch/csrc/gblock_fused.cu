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
// computes given bf16 operands: bf16 x, k1, k2, ksc and out; the affines
// (a1, b1, a2, b2, b_out) stay f32, as pallas_gblock.py builds its (5, C)
// affine. relu(a1 * x + b1) is computed in f32 and rounded to bf16 as it
// enters conv1; mid stays f32 (the TPU kernel's f32 `mid`) and is rounded to
// bf16 as it enters conv2; the shortcut reads bf16 x; sums are f32 and out is
// rounded once. Both launches run on the bf16 tensor cores (igemm.cuh's bf16
// path), with the f32 kernels' tile shapes; at N = 288 the two convs are
// 391 GFLOP, 0.40 ms at 989 TFLOP/s, against 0.07-0.27 ms for their bytes.

#include "igemm.cuh"

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
// bf16 variant.

struct GBlockBfArgs {
  const uint16_t* x;  // (N, H, W, Cin) bf16
  const float* mid_in;
  const uint16_t* k1;
  const uint16_t* k2;
  const uint16_t* ksc;
  const float* a1;
  const float* b1;
  const float* a2;
  const float* b2;
  const float* b_out;
  float* mid;     // (N, H, W, Cin) f32
  uint16_t* out;  // (N, H, W, Cout) bf16
  int use_sc_conv;
  int N, H, W, Cin, Cout;
};

template <class Cfg, bool VEC>
__global__ void __launch_bounds__(Cfg::THREADS, 2) gblock_conv1_bf16_kernel(GBlockBfArgs p) {
  extern __shared__ __align__(16) char smem_bf[];
  const int M = p.N * p.H * p.W;
  const int C = p.Cin;
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * Cfg::BN;
  float* scale = reinterpret_cast<float*>(smem_bf + Cfg::SMEM_BYTES);  // a1, b1 behind the ring
  float* shift = scale + C;
  for (int c = threadIdx.x; c < C; c += Cfg::THREADS) {
    scale[c] = p.a1[c];
    shift[c] = p.b1[c];
  }
  __syncthreads();
  float acc[Cfg::MT][Cfg::NT][4] = {};
  const ConvBf<uint16_t> op{p.x, p.k1, scale, shift, p.H, p.W, C, C};
  conv_tile_bf<Cfg, uint16_t, 3, VEC, true>(acc, smem_bf, op, M, m0, n0, 0, cdiv(9 * C, Cfg::BK));
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

template <class Cfg, bool VEC>
__global__ void __launch_bounds__(Cfg::THREADS, 2) gblock_conv2_bf16_kernel(GBlockBfArgs p) {
  extern __shared__ __align__(16) char smem_bf[];
  const int M = p.N * p.H * p.W;
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * Cfg::BN;
  float acc[Cfg::MT][Cfg::NT][4] = {};
  const ConvBf<float> op{p.mid_in, p.k2, nullptr, nullptr, p.H, p.W, p.Cin, p.Cout};
  conv_tile_bf<Cfg, float, 3, VEC, false>(acc, smem_bf, op, M, m0, n0, 0, cdiv(9 * p.Cin, Cfg::BK));
  if (p.use_sc_conv) {  // uniform across the grid, so the barriers inside stay uniform
    const ConvBf<uint16_t> sc{p.x, p.ksc, nullptr, nullptr, p.H, p.W, p.Cin, p.Cout};
    conv_tile_bf<Cfg, uint16_t, 1, VEC, false>(acc, smem_bf, sc, M, m0, n0, 0,
                                               cdiv(p.Cin, Cfg::BK));
  }
  float add[Cfg::NT * 4];
  epilogue<Cfg>(
      acc, m0, n0,
      [&](int j, int m, int n) {
        const bool ok = m < M && n < p.Cout;
        add[j] = ok ? p.b_out[n] : 0.f;
        if (ok && !p.use_sc_conv) add[j] += bf16_to_f32(p.x[(size_t)m * p.Cout + n]);  // identity
      },
      [&](int j, int m, int n, float v) {
        if (m < M && n < p.Cout) p.out[(size_t)m * p.Cout + n] = f32_to_bf16(v + add[j]);
      });
}

using MidBf = BfCfg<128, 96, 2, 4>;
using NarrowBf = BfCfg<128, 64, 4, 2>;

template <class Cfg, bool VEC>
cudaError_t launch_conv_bf(bool second, const GBlockBfArgs& p, int nout, cudaStream_t stream) {
  auto kernel = second ? gblock_conv2_bf16_kernel<Cfg, VEC> : gblock_conv1_bf16_kernel<Cfg, VEC>;
  const int smem = Cfg::SMEM_BYTES + (second ? 0 : 2 * p.Cin * (int)sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(p.N * p.H * p.W, Cfg::BM), cdiv(nout, Cfg::BN));
  kernel<<<grid, Cfg::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_vec_bf(bool second, const GBlockBfArgs& p, int nout, cudaStream_t stream) {
  if (nout % NarrowBf::BN != 0 && nout % MidBf::BN == 0)
    return launch_conv_bf<MidBf, VEC>(second, p, nout, stream);
  return launch_conv_bf<NarrowBf, VEC>(second, p, nout, stream);
}

cudaError_t launch_bf(bool second, const GBlockBfArgs& p, cudaStream_t stream) {
  const int nout = second ? p.Cout : p.Cin;
  // 16-byte copies: 8 bf16 (x, kernels) or 4 f32 (mid) per copy.
  const bool vec = p.Cin % 8 == 0 && nout % 8 == 0 && aligned16(p.x) && aligned16(p.mid_in) &&
                   aligned16(p.k1) && aligned16(p.k2) && aligned16(p.ksc);
  return vec ? launch_vec_bf<true>(second, p, nout, stream)
             : launch_vec_bf<false>(second, p, nout, stream);
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

// bf16 variant: x, k1, mid as for gblock_conv1_f32 but x and k1 bf16; affines f32.
int gblock_conv1_bf16(const uint16_t* x, const uint16_t* k1, const float* a1, const float* b1,
                      const float* a2, const float* b2, float* mid, int N, int H, int W, int C,
                      void* stream) {
  dgmr::GBlockBfArgs p{};
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
  return static_cast<int>(dgmr::launch_bf(false, p, static_cast<cudaStream_t>(stream)));
}

int gblock_conv2_bf16(const float* mid, const uint16_t* x, const uint16_t* k2, const uint16_t* ksc,
                      const float* b_out, uint16_t* out, int use_sc_conv, int N, int H, int W,
                      int Cin, int Cout, void* stream) {
  dgmr::GBlockBfArgs p{};
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
  return static_cast<int>(dgmr::launch_bf(true, p, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
