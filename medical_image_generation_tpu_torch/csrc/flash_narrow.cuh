// Helpers of the narrow-head flash kernels (flash_attn_narrow_fwd.cu,
// flash_attn_narrow_bwd.cu), on top of flash_common.cuh.
//
// A narrow tile holds all of a padded head dim DP = 32 or 64 bf16 columns in
// one row of 2*DP bytes (64 or 128), swizzled at that width: TMA's 64-byte
// swizzle at DP = 32, its 128-byte swizzle at DP = 64, so that one swizzle
// atom is exactly one row of 8-row groups (512 or 1024 bytes). Rows past S
// and columns past D are TMA's zero fill.
//   * `make_map_narrow` (host): the tensor map of a bf16 (B, S, H, D) view in
//     boxes of DP columns by `rows` rows.
//   * `narrow_kmajor` / `narrow_mnmajor`: wgmma descriptors of such a tile as
//     a K-major operand (rows = M or N, a k16 step is +32 bytes, 8-row groups
//     8*2*DP bytes apart) or an MN-major one (rows = K, the DP columns are N,
//     a k16 step is 16 rows on, 8-row groups 8*2*DP bytes apart).
//   * the wgmma shapes the narrow tiles add: scores of 64 keys or queries
//     (m64n64k16, both operands K-major) and D += A B at N = 32 (m64n32k16, A
//     from registers, B MN-major).
//   * `ex2`: 2^x on the special-function unit (ex2.approx, flush to zero).
#pragma once

#include "flash_common.cuh"

namespace {

constexpr int NARROW_MAX_D = 64;  // head dims (padded to 8) the narrow kernels take

// wgmma layout type of a row of 2*DP bytes: 2 = 64-byte swizzle, 1 = 128-byte.
template <int DP>
__host__ __device__ constexpr uint64_t narrow_layout() {
    static_assert(DP == 32 || DP == 64, "narrow tiles are 32 or 64 columns");
    return DP == 32 ? 2 : 1;
}

template <int DP>
__device__ __forceinline__ uint64_t narrow_desc(const void* p, unsigned lbo, unsigned sbo) {
    const uint64_t a = smem_u32(p);
    return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (narrow_layout<DP>() << 62);
}
// K-major: the leading offset is unused (the k16 step lies inside the swizzle atom).
template <int DP>
__device__ __forceinline__ uint64_t narrow_kmajor(const void* p) {
    return narrow_desc<DP>(p, 16, 16 * DP);
}
// MN-major: N = DP is one swizzle atom wide, so the leading offset (the next
// atom of N) is unused too.
template <int DP>
__device__ __forceinline__ uint64_t narrow_mnmajor(const void* p) {
    return narrow_desc<DP>(p, 16, 16 * DP);
}

// Tensor map of a bf16 view with element (b, s, h, d) at base + b*sb + s*ss +
// h*D + d, as make_map_bshd, in boxes of DP columns x `rows` rows swizzled at
// 2*DP bytes. Returns a cudaError_t code.
template <int DP>
inline int make_map_narrow(CUtensorMap* map, const void* base, int B, int H, int S, int D,
                           long long sb, long long ss, int rows) {
    EncodeTiledFn fn = encode_tiled();
    if (!fn) return (int)cudaErrorNotSupported;
    if (B == 1) sb = ss * S;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {(cuuint32_t)DP, 1, (cuuint32_t)rows, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          DP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// d (64 x 64 f32) = (scale_d ? d : 0) + A B^T: A (64 x 16) and B (64 x 16)
// bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_scores(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32 f32) += A B: A (64 x 16 bf16) in registers (the mma.sync
// m16n8k16 A-fragment layout over each warp's 16 rows), B (16 x 32) in
// shared memory, MN-major.
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[16], const unsigned (&a)[4],
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Stores this thread's rows (row0 + 16w + g + 8r, those under S) of a 64-row
// f32 accumulator, times mul[r], as bf16 into a (B, S, H, D) tensor at (b,
// row, h): columns under D only.
template <int N>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[N], const float (&mul)[2],
                                           int b, int h, int H, int S, int D, int row0, int w,
                                           int g, int tq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * w + g + 8 * r;
        if (row >= S) continue;
        bf16* orow = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
            const int c = 8 * i + 2 * tq;
            if (c < D)
                *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
                    acc[4 * i + 2 * r] * mul[r], acc[4 * i + 2 * r + 1] * mul[r]);
        }
    }
}

}  // namespace
