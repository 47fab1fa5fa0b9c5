// Thin wrappers over the PTX the port's f32 kernels use (sm_80+ instructions,
// built for sm_90a): cp.async with zero-fill, the 3xTF32 operand split, the
// m16n8k8 TF32 tensor-core product and an L2 prefetch. The bf16 kernels'
// Hopper instructions are in hopper.cuh.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dgmr {

// 16-byte global -> shared copy that bypasses L1 (.cg). With valid == false
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 3xTF32 operand split, x ~= hi + lo, with no conversion instructions (cvt
// runs at a quarter of the FP32 rate and would bound the mainloop): hi is x
// with its low 13 mantissa bits cleared (TF32, truncated), x - hi is exact in
// f32, and lo is that remainder truncated to TF32 the same way. Dropping lo's
// own tail and lo * lo leaves ~2^-20 of each product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a * b for one 16x8x8 TF32 tile, f32 accumulators (fragment layouts of
// mma.sync.m16n8k8: a row-major 16x8, b column-major 8x8, d row-major 16x8).
// Not volatile: it has no side effects, so the compiler may interleave
// independent tiles' products instead of stalling on each one's latency.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

}  // namespace dgmr
