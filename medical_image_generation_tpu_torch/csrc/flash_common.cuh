// Device helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): warp reductions, cp.async, ldmatrix, bf16 mma.sync
// m16n8k16 with f32 accumulation, and tile loads into shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // 227 KB opt-in limit of one block on H100

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows x Dp bf16 tile into shared memory (row stride ld); rows >= rows_valid
// and columns >= D are zero-filled. vec: 16-byte cp.async (asynchronous,
// the caller commits and waits); else synchronous element loads.
__device__ void load_tile_bf16(bf16* dst, int ld, const bf16* src, long long row_stride,
                               int rows_valid, int rows, int D, int Dp, bool vec) {
    const int cpr = Dp / 8;
    for (int idx = threadIdx.x; idx < rows * cpr; idx += NTHREADS) {
        const int r = idx / cpr, c = (idx - r * cpr) * 8;
        bf16* d = dst + r * ld + c;
        const bool ok = r < rows_valid && c < D;
        if (vec) {
            cp_async16(d, ok ? src + r * row_stride + c : src, ok ? 16 : 0);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                d[e] = (r < rows_valid && c + e < D) ? src[r * row_stride + c + e]
                                                     : __float2bfloat16(0.f);
        }
    }
}

__device__ void load_tile_f32(float* dst, int ld, const float* src, long long row_stride,
                              int rows_valid, int rows, int D, int Dp) {
    for (int idx = threadIdx.x; idx < rows * Dp; idx += NTHREADS) {
        const int r = idx / Dp, c = idx - r * Dp;
        dst[r * ld + c] = (r < rows_valid && c < D) ? src[r * row_stride + c] : 0.f;
    }
}

}  // namespace
