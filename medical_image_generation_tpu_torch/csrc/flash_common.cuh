// Helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu).
//
// The f32 paths: warp reductions and f32 tile loads into shared memory.
//
// Hopper (the bf16 forward, dQ and dK/dV kernels):
//   * TMA: `make_map_bshd` (host) describes a bf16 (B, S, H, D) view as a 4-D
//     tensor map cut into boxes of 64 columns of D (128 bytes a row) by 64,
//     32 or 16 rows of S, 128-byte swizzled, zero-filled outside S and D;
//     `tma_load_box` copies one box into shared memory and reports its bytes
//     to an mbarrier. cuTensorMapEncodeTiled is looked up at run time
//     (cudaGetDriverEntryPoint), so the library links nothing but cudart.
//   * mbarriers: init, arrive, expect-tx, parity waits at CTA scope, and an
//     arrive with release semantics at cluster scope on the barrier at the
//     same offset in another CTA of the cluster (`mbar_arrive_cluster`),
//     waited for with acquire semantics at cluster scope.
//   * clusters: the CTA's rank, a whole-cluster barrier, and 16-byte loads
//     from and stores into the shared memory of another CTA of the cluster
//     (DSMEM, `mapa` + `ld.shared::cluster`; `st.async`, whose bytes complete
//     a transaction on an mbarrier there).
//   * wgmma: shared-memory matrix descriptors for the 128-byte swizzled boxes
//     (`sw128_desc`), fence / commit / wait, `fence_operand` (keeps the
//     compiler from moving register reads or writes across an asynchronous
//     wgmma), and m64nNk16 bf16 products with f32 accumulators: S = A B^T
//     with both operands K-major in shared memory (N = 16 or 32), and D += A B
//     with A in registers and B MN-major in shared memory (N = 64, 128, 192,
//     256); `acc_to_a` turns an m64n16 or m64n32 accumulator into A fragments.
//   * partial score tiles: `slot_store` / `slot_add` / `slot_publish` /
//     `slot_wait` exchange 64 x 16 or 64 x 32 f32 tiles between warpgroups
//     and CTAs.
//   * `producer_regs` / `consumer_regs` (setmaxnreg), `allow_smem`, and the
//     head-dim `Split` of the forward and dQ kernels.
// Box layout: a bf16 box is 64 columns (128 bytes) by 64, 32 or 16 rows (8,
// 4 or 2 KB), row r at r * 128 bytes, its 16-byte groups XOR-swizzled by r % 8
// (TMA's SWIZZLE_128B). As a K-major operand (rows = M or N, K along the
// row) a k16 step is +32 bytes and 8-row groups are 1024 bytes apart (SBO);
// as an MN-major operand (rows = K, N along the row) a k16 step is +2048
// bytes, 8-row groups are 1024 bytes apart (SBO), and the next 64 columns of
// N are the next box, one box size on (LBO).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
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

__device__ void load_tile_f32(float* dst, int ld, const float* src, long long row_stride,
                              int rows_valid, int rows, int D, int Dp) {
    for (int idx = threadIdx.x; idx < rows * Dp; idx += NTHREADS) {
        const int r = idx / Dp, c = idx - r * Dp;
        dst[r * ld + c] = (r < rows_valid && c < D) ? src[r * row_stride + c] : 0.f;
    }
}

// ---------------------------------------------------------------- Hopper

constexpr int BOX = 64;    // bf16 columns (128 bytes) of a TMA box; rows of a resident block
constexpr int TILE = 32;   // rows of a streamed tile (keys in the forward, queries in dK/dV)
constexpr unsigned BOX_BYTES = BOX * 128;    // 64-row box, 8 KB
constexpr unsigned TBOX_BYTES = TILE * 128;  // 32-row box, 4 KB
constexpr unsigned SLOT_F4 = BOX * TILE / 4;  // one f32 64 x 32 score tile, in float4
constexpr int MAX_D = 768;  // bf16 head dims taken: 2 CTAs x 2 warpgroups x 3 chunks of 64

// Head-dim split of one 64-row block of the forward and dQ kernels: NC
// 64-column chunks over n CTAs x 2 warpgroups, cpc chunks each (n = 1 up to
// D = 512, 2 above).
struct Split {
    int n, cpc;
    explicit Split(int D) {
        const int nc = (D + BOX - 1) / BOX;
        n = nc <= 8 ? 1 : 2;
        cpc = (nc + 2 * n - 1) / (2 * n);
    }
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
                cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// Tensor map of a bf16 view with element (b, s, h, d) at base + b*sb + s*ss +
// h*D + d: dims (D, H, S, B), boxes of 64 columns x `rows` rows of S, where S
// is the length of this tensor (Sq for q and dO, Sk for k and v: a box may
// be longer than S, and TMA zero-fills the rows past it). Needs a 16-byte
// aligned base and D, ss, sb multiples of 8. Returns a cudaError_t code.
inline int make_map_bshd(CUtensorMap* map, const void* base, int B, int H, int S, int D,
                         long long sb, long long ss, int rows) {
    EncodeTiledFn fn = encode_tiled();
    if (!fn) return (int)cudaErrorNotSupported;
    if (B == 1) sb = ss * S;  // any valid stride for a dimension of size 1 (S: this tensor's)
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Opt a kernel into `bytes` of dynamic shared memory, once per kernel (the
// call costs host time on every launch otherwise).
template <auto Kernel>
inline int allow_smem(unsigned bytes) {
    static int err = -1;
    if (err < 0)
        err = (int)cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)bytes);
    return err;
}

// Dynamic shared memory rounded up to 1024 bytes (the 128-byte swizzle's period).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    const unsigned a = smem_u32(p);
    return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, int d0, int h,
                                             int s0, int b, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(s0),
        "r"(b), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive, releasing this thread's (and, through a preceding CTA barrier, its
// CTA's) writes at cluster scope, on the barrier at bar's offset in CTA `rank`.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned rank) {
    asm volatile(
        "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n"
        ::"r"(smem_u32(bar)), "r"(rank)
        : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return done;
}
// test_wait (no suspension): the arrivals come from other SMs.
__device__ __forceinline__ bool mbar_try_wait_cluster(uint64_t* bar, unsigned parity) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return done;
}
// Spin until the phase of parity `parity` has completed. A phase that never
// completes is a fault, not a wait: after ~2^35 cycles (over 10 s) the kernel
// traps, and the launch fails instead of hanging the card.
template <bool CLUSTER>
__device__ __forceinline__ void mbar_wait_impl(uint64_t* bar, unsigned parity) {
    long long t0 = 0;
    for (unsigned it = 1;; ++it) {
        if (CLUSTER ? mbar_try_wait_cluster(bar, parity) : mbar_try_wait(bar, parity)) return;
        if ((it & 1023u) == 0) {
            const long long now = clock64();
            if (t0 == 0) t0 = now;
            else if (now - t0 > (1ll << 35)) __trap();
        }
    }
}
// CTA-scope acquire.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    mbar_wait_impl<false>(bar, parity);
}
// Cluster-scope acquire: pairs with mbar_arrive_cluster.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
    mbar_wait_impl<true>(bar, parity);
}

__device__ __forceinline__ unsigned cluster_ctarank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
// Every thread of every CTA of the cluster (not .aligned: callable from
// diverged warps).
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// 16 bytes at p's offset in the shared memory of CTA `rank` of the cluster.
__device__ __forceinline__ float4 ld_dsmem_f4(const void* p, unsigned rank) {
    unsigned ra;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(ra) : "r"(smem_u32(p)), "r"(rank));
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(ra)
                 : "memory");
    return v;
}
// 16 bytes into p's offset in the shared memory of CTA `rank` of the cluster,
// counted as complete-tx bytes on the mbarrier at bar's offset there: the data
// is visible to a thread of that CTA once it has seen the barrier's phase end.
__device__ __forceinline__ void st_async_f4(const void* p, float4 v, const uint64_t* bar,
                                            unsigned rank) {
    asm volatile(
        "{\n.reg .b32 ra, rb;\nmapa.shared::cluster.u32 ra, %0, %6;\n"
        "mapa.shared::cluster.u32 rb, %1, %6;\n"
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [ra], {%2, %3, %4, %5}, "
        "[rb];\n}\n"
        ::"r"(smem_u32(p)), "r"(smem_u32(bar)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rank)
        : "memory");
}
// Registers a thread of this warpgroup may hold from here on. A CTA of two
// consumer warpgroups and one producer warpgroup starts at 168 a thread (384
// x 168 of the 65,536); the producer gives back 128 a thread, exactly what
// the consumers take to hold their accumulators.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int WS_THREADS = 384;  // two consumer warpgroups + one producer warpgroup
__device__ __forceinline__ void producer_regs() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
__device__ __forceinline__ void consumer_regs() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// Barrier `id` over the first `count` threads of the CTA.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand at p
// (1024-byte aligned box base plus a k offset), strides in bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo, unsigned sbo) {
    const uint64_t a = smem_u32(p);
    return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) { return sw128_desc(p, 16, 1024); }
// MN-major operand whose next 64 columns of N are the next box, box_bytes on.
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p, unsigned box_bytes) {
    return sw128_desc(p, box_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this thread are pending.
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N> __device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N> __device__ __forceinline__ void fence_operand(unsigned (&r)[M][N]) {
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
        for (int k = 0; k < N; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

// Score tiles (64 x 16 or 64 x 32 f32) are exchanged through shared memory
// (the other warpgroup of the CTA) and DSMEM (the other CTAs of the cluster).
// A thread keeps its N accumulator floats as N/4 float4 at slot[i * 128 + t]
// (consecutive threads on consecutive 16 bytes); every warpgroup and CTA uses
// the same layout, so thread t reads the values of its own elements.
template <int N>
__device__ __forceinline__ void slot_store(float4* slot, const float (&v)[N], int t) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
        slot[i * 128 + t] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
// v = (first ? 0 : v) + the partial at `slot` in CTA `rank` (through DSMEM
// when remote, else this CTA's own shared memory).
template <int N>
__device__ __forceinline__ void slot_add(float (&v)[N], const float4* slot, int t, unsigned rank,
                                         bool remote, bool first) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
        const float4 b = remote ? ld_dsmem_f4(&slot[i * 128 + t], rank) : slot[i * 128 + t];
        if (first) {
            v[4 * i] = b.x; v[4 * i + 1] = b.y; v[4 * i + 2] = b.z; v[4 * i + 3] = b.w;
        } else {
            v[4 * i] += b.x; v[4 * i + 1] += b.y; v[4 * i + 2] += b.z; v[4 * i + 3] += b.w;
        }
    }
}
// After every thread of warpgroup `wg` stored its slot: thread r tells CTA
// r0 + r of the cluster (itself among them) that this warpgroup's partial is
// ready.
__device__ __forceinline__ void slot_publish(uint64_t* ready, int wg, int t, int n, int r0 = 0) {
    named_bar_sync(1 + wg, 128);
    if (t < n) mbar_arrive_cluster(ready, r0 + t);
}
// Wait until every partial of this phase is ready: one thread acquires at
// cluster scope, the warpgroup's barrier passes that on to the others.
__device__ __forceinline__ void slot_wait(uint64_t* ready, unsigned parity, int wg, int t) {
    if (t == 0) mbar_wait_cluster(ready, parity);
    named_bar_sync(1 + wg, 128);
}

// Two f32 as one bf16x2 register, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
}
// The wgmma A fragment of columns 16kk..16kk+15 of an m64n16 or m64n32 f32
// accumulator (its n8 tiles 2kk and 2kk+1 hold exactly those columns).
template <int N>
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4], const float (&s)[N], int kk) {
    a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// d (64 x 32 f32) = (scale_d ? d : 0) + A B^T: A (64 x 16) and B (32 x 16) bf16 in
// shared memory, both K-major, 128-byte swizzled (descriptors from sw128_desc).
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                   int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 16 f32) = (scale_d ? d : 0) + A B^T, as wgmma_m64n32k16_ss with B
// (16 x 16) of 16 rows.
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t a, uint64_t b,
                                                   int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
}
// Both score shapes behind one name: N = 16 or 32 keys.
__device__ __forceinline__ void wgmma_scores(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    wgmma_m64n16k16_ss(d, a, b, scale_d);
}
__device__ __forceinline__ void wgmma_scores(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    wgmma_m64n32k16_ss(d, a, b, scale_d);
}

// d (64 x 64 f32) += A B: A (64 x 16 bf16) in registers, in the mma.sync
// m16n8k16 A-fragment layout over each warp's 16 rows; B (16 x 64) in shared
// memory, MN-major (N contiguous), 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[32], const unsigned (&a)[4],
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 f32) += A B: A (64 x 16 bf16) in registers, in the mma.sync
// m16n8k16 A-fragment layout over each warp's 16 rows; B (16 x 128) in shared
// memory, MN-major (N contiguous), 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[64], const unsigned (&a)[4],
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 192 f32) += A B: A (64 x 16 bf16) in registers, in the mma.sync
// m16n8k16 A-fragment layout over each warp's 16 rows; B (16 x 192) in shared
// memory, MN-major (N contiguous), 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[96], const unsigned (&a)[4],
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256 f32) += A B: A (64 x 16 bf16) in registers, in the mma.sync
// m16n8k16 A-fragment layout over each warp's 16 rows; B (16 x 256) in shared
// memory, MN-major (N contiguous), 128-byte swizzled.
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[128], const unsigned (&a)[4],
                                                  uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace
