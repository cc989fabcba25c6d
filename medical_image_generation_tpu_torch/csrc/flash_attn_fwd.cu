// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_kernel` / `_flash_forward` in
// medical_image_generation_tpu/ops/pallas_attention.py (:61-184): softmax(scale * Q K^T) V
// over (B*H, S, D) with an online softmax across K tiles, f32 running max m,
// f32 running sum l and an f32 output accumulator, and no S x S buffer. It
// writes O (input dtype) and the f32 row logsumexp (B*H, S) that a backward
// pass consumes.
//
// Bound on this card: operations. 4*B*H*S^2*D FLOP at 989 TFLOP/s (bf16 tensor
// cores); the bytes (Q, K, V read once, O written once) are ~1% of that time
// at the U-Net's shapes (S=4096, D=512 and S=512, D=768).
//
// Design. The TPU kernel walks K blocks sequentially inside one grid step;
// here a CUDA block owns BQ = 32 query rows of one (batch, head) and loops
// over K/V tiles of BK rows, so blocks are independent.
//
// bf16 (the model's path): tensor-core mma.sync m16n8k16 with f32
// accumulation, operands fed from shared memory by ldmatrix. The head dims
// here (512, 768) are too wide for one warp to hold a row block's output
// accumulator, so the 8 warps split the output's D axis: warp w keeps the
// f32 accumulator of all 32 rows x its D/8 columns in registers (up to 96
// floats a thread at D=768) and rescales it in place with the online-softmax
// correction. Scores are computed by the warps as 16x8 tiles over the full
// D, staged in shared memory (f32), turned into bf16 probabilities by one
// warp per row, and multiplied by V. Q, K and V tiles are copied into shared
// memory with cp.async: the next K tile is in flight during the softmax and
// P V, the V tile during Q K^T. BK is 64 while Q + K + V tiles fit the 227 KB
// of shared memory (D <= 640) and 32 above.
//
// f32 (used to check the port against the CPU in fp32): the same tiling with
// scalar f32 FMAs and a shared-memory accumulator, BQ = BK = 16.
//
// D is zero-padded in shared memory (to a multiple of 64 for bf16, of 4 for
// f32) and ragged S is masked: padded keys get probability 0 and padded
// query rows are never stored, so any S and any D that fits are taken.
//
// Not yet: wgmma, TMA, warp specialisation, a persistent grid.

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

__device__ __forceinline__ void store_p(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_p(bf16* p, float v) { *p = __float2bfloat16(v); }

// Online softmax over one score tile: sS (BQ x BK f32, unscaled) -> sP
// (probabilities), updating the running max sM and sum sL and writing the
// accumulator correction sC = exp(m_old - m_new). One warp per row; BK <= 64.
template <typename P>
__device__ void online_softmax(const float* sS, int lds, P* sP, int ldp, float* sM, float* sL,
                               float* sC, int BQ, int BK, int nk, float scale) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < BQ; r += NWARPS) {
        float s[2];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = lane + 32 * i;
            s[i] = (c < BK && c < nk) ? sS[r * lds + c] * scale : -INFINITY;
            mx = fmaxf(mx, s[i]);
        }
        const float m_prev = sM[r];
        const float m_new = fmaxf(m_prev, warp_max(mx));
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = lane + 32 * i;
            const float p = (c < BK && c < nk) ? expf(s[i] - m_new) : 0.f;
            psum += p;
            if (c < BK) store_p(sP + r * ldp + c, p);
        }
        psum = warp_sum(psum);
        if (lane == 0) {
            const float corr = expf(m_prev - m_new);
            sM[r] = m_new;
            sL[r] = sL[r] * corr + psum;
            sC[r] = corr;
        }
    }
}

// ----------------------------------------------------------------- bf16 path

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

constexpr int BQ16 = 32;  // query rows per block (two m16 tiles)

struct LayoutBf16 {
    int Dp, ldt, lds, ldp;
    size_t off_k, off_v, off_s, off_p, off_stat, total;
    __host__ __device__ LayoutBf16(int D, int BK) {
        Dp = (D + 63) & ~63;
        ldt = Dp + 8;  // +16 bytes a row: conflict-free ldmatrix
        lds = BK + 4;
        ldp = BK + 8;
        off_k = align128(sizeof(bf16) * BQ16 * ldt);
        off_v = off_k + align128(sizeof(bf16) * BK * ldt);
        off_s = off_v + align128(sizeof(bf16) * BK * ldt);
        off_p = off_s + align128(sizeof(float) * BQ16 * lds);
        off_stat = off_p + align128(sizeof(bf16) * BQ16 * ldp);
        total = off_stat + align128(sizeof(float) * 3 * BQ16);
    }
};

// NT: n8 tiles of the output each warp owns (D padded to 64*NT); BK: keys a tile.
template <int NT, int BK>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
               int H, int S, int D, long long q_sb, long long q_ss, long long k_sb,
               long long k_ss, long long v_sb, long long v_ss, float scale, bool vec) {
    constexpr int NPW = BK / 32;  // score n8 tiles per warp: 2 m16 x BK/8 tiles over 8 warps
    extern __shared__ __align__(128) unsigned char smem[];
    const LayoutBf16 L(D, BK);
    const int Dp = L.Dp, ldt = L.ldt, lds = L.lds, ldp = L.ldp;
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sK = reinterpret_cast<bf16*>(smem + L.off_k);
    bf16* sV = reinterpret_cast<bf16*>(smem + L.off_v);
    float* sS = reinterpret_cast<float*>(smem + L.off_s);
    bf16* sP = reinterpret_cast<bf16*>(smem + L.off_p);
    float* sM = reinterpret_cast<float*>(smem + L.off_stat);
    float* sL = sM + BQ16;
    float* sC = sL + BQ16;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.x * BQ16;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const bf16* qb = q + b * q_sb + (long long)h * D;
    const bf16* kb = k + b * k_sb + (long long)h * D;
    const bf16* vb = v + b * v_sb + (long long)h * D;
    const int ntiles = (S + BK - 1) / BK;

    load_tile_bf16(sQ, ldt, qb + q0 * q_ss, q_ss, min(BQ16, S - q0), BQ16, D, Dp, vec);
    load_tile_bf16(sK, ldt, kb, k_ss, min(BK, S), BK, D, Dp, vec);
    cp_async_commit();
    load_tile_bf16(sV, ldt, vb, v_ss, min(BK, S), BK, D, Dp, vec);
    cp_async_commit();
    for (int i = threadIdx.x; i < BQ16; i += NTHREADS) { sM[i] = -1e30f; sL[i] = 0.f; }

    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

    const int col0 = warp * 8 * NT;  // this warp's first output column
    for (int j = 0; j < ntiles; ++j) {
        const int k0 = j * BK, nk = min(BK, S - k0);
        const bool more = j + 1 < ntiles;
        cp_async_wait<1>();  // Q and this K tile landed; this V tile may be in flight
        __syncthreads();

        {  // scores: warp (mi, n tiles nb..nb+NPW-1) of the 32 x BK tile, over all of Dp
            const int mi = warp & 1, nb = (warp >> 1) * NPW;
            float sc[NPW][4];
#pragma unroll
            for (int i = 0; i < NPW; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
            for (int kk = 0; kk < Dp / 16; ++kk) {
                unsigned a[4];
                ldsm_x4(a, sQ + (mi * 16 + (lane % 16)) * ldt + kk * 16 + (lane / 16) * 8);
#pragma unroll
                for (int i = 0; i < NPW; ++i) {
                    unsigned bfr[2];
                    ldsm_x2(bfr, sK + ((nb + i) * 8 + (lane % 8)) * ldt + kk * 16 +
                                     ((lane / 8) % 2) * 8);
                    mma_bf16(sc[i], a, bfr);
                }
            }
#pragma unroll
            for (int i = 0; i < NPW; ++i) {
                const int c = (nb + i) * 8 + 2 * t;
                *reinterpret_cast<float2*>(sS + (mi * 16 + g) * lds + c) =
                    make_float2(sc[i][0], sc[i][1]);
                *reinterpret_cast<float2*>(sS + (mi * 16 + g + 8) * lds + c) =
                    make_float2(sc[i][2], sc[i][3]);
            }
        }
        __syncthreads();  // K tile consumed: start the next one
        if (more) {
            load_tile_bf16(sK, ldt, kb + (k0 + BK) * k_ss, k_ss, min(BK, S - k0 - BK), BK, D,
                           Dp, vec);
            cp_async_commit();
        }

        online_softmax(sS, lds, sP, ldp, sM, sL, sC, BQ16, BK, nk, scale);
        if (more) cp_async_wait<1>(); else cp_async_wait<0>();  // this V tile landed
        __syncthreads();

        // O = O * corr + P V on this warp's columns
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
            const float c_lo = sC[mi * 16 + g], c_hi = sC[mi * 16 + g + 8];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                acc[mi][nt][0] *= c_lo; acc[mi][nt][1] *= c_lo;
                acc[mi][nt][2] *= c_hi; acc[mi][nt][3] *= c_hi;
            }
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            unsigned a0[4], a1[4];
            ldsm_x4(a0, sP + (lane % 16) * ldp + kk * 16 + (lane / 16) * 8);
            ldsm_x4(a1, sP + (16 + lane % 16) * ldp + kk * 16 + (lane / 16) * 8);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                unsigned bfr[2];
                ldsm_x2_trans(bfr, sV + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ldt +
                                       col0 + nt * 8);
                mma_bf16(acc[0][nt], a0, bfr);
                mma_bf16(acc[1][nt], a1, bfr);
            }
        }
        __syncthreads();  // V tile consumed: start the next one
        if (more) {
            load_tile_bf16(sV, ldt, vb + (k0 + BK) * v_ss, v_ss, min(BK, S - k0 - BK), BK, D,
                           Dp, vec);
            cp_async_commit();
        }
    }

    // O = acc / l into (B, S, H, D); lse = m + log(l) into (B*H, S)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = mi * 16 + g + 8 * half;
            if (q0 + r >= S) continue;
            const float inv = 1.f / sL[r];
            bf16* orow = o + (((long long)b * S + q0 + r) * H + h) * D;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int c = col0 + nt * 8 + 2 * t;
                if (c < D) orow[c] = __float2bfloat16(acc[mi][nt][2 * half] * inv);
                if (c + 1 < D) orow[c + 1] = __float2bfloat16(acc[mi][nt][2 * half + 1] * inv);
            }
        }
    }
    const int nq = min(BQ16, S - q0);
    for (int r = threadIdx.x; r < nq; r += NTHREADS)
        lse[(long long)bh * S + q0 + r] = sM[r] + logf(sL[r]);
}

int pick_bk(int D) { return LayoutBf16(D, 64).total <= MAX_SMEM ? 64 : 32; }

template <int NT, int BK>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int H, int S, int D, long long q_sb, long long q_ss, long long k_sb,
                long long k_ss, long long v_sb, long long v_ss, float scale, int vec,
                cudaStream_t st) {
    const size_t smem = LayoutBf16(D, BK).total;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<NT, BK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + BQ16 - 1) / BQ16, B * H);
    flash_fwd_bf16<NT, BK><<<grid, NTHREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, H, S, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
        vec != 0);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ f32 path

constexpr int BQ32 = 16, BK32 = 16;

struct LayoutF32 {
    int Dp, ldt, ldo, lds, ldp;
    size_t off_kv, off_o, off_s, off_p, off_stat, total;
    __host__ __device__ explicit LayoutF32(int D) {
        Dp = (D + 3) & ~3;
        ldt = Dp + 4;
        ldo = Dp + 4;
        lds = BK32 + 4;
        ldp = BK32 + 4;
        off_kv = align128(sizeof(float) * BQ32 * ldt);
        off_o = off_kv + align128(sizeof(float) * BK32 * ldt);
        off_s = off_o + align128(sizeof(float) * BQ32 * ldo);
        off_p = off_s + align128(sizeof(float) * BQ32 * lds);
        off_stat = off_p + align128(sizeof(float) * BQ32 * ldp);
        total = off_stat + align128(sizeof(float) * 3 * BQ32);
    }
};

__device__ void load_tile_f32(float* dst, int ld, const float* src, long long row_stride,
                              int rows_valid, int rows, int D, int Dp) {
    for (int idx = threadIdx.x; idx < rows * Dp; idx += NTHREADS) {
        const int r = idx / Dp, c = idx - r * Dp;
        dst[r * ld + c] = (r < rows_valid && c < D) ? src[r * row_stride + c] : 0.f;
    }
}

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int H, int S, int D, long long q_sb, long long q_ss, long long k_sb,
              long long k_ss, long long v_sb, long long v_ss, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const LayoutF32 L(D);
    const int Dp = L.Dp, ldt = L.ldt, ldo = L.ldo, lds = L.lds, ldp = L.ldp;
    float* sQ = reinterpret_cast<float*>(smem);
    float* sKV = reinterpret_cast<float*>(smem + L.off_kv);
    float* sO = reinterpret_cast<float*>(smem + L.off_o);
    float* sS = reinterpret_cast<float*>(smem + L.off_s);
    float* sP = reinterpret_cast<float*>(smem + L.off_p);
    float* sM = reinterpret_cast<float*>(smem + L.off_stat);
    float* sL = sM + BQ32;
    float* sC = sL + BQ32;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.x * BQ32;
    const float* qb = q + b * q_sb + (long long)h * D;
    const float* kb = k + b * k_sb + (long long)h * D;
    const float* vb = v + b * v_sb + (long long)h * D;

    load_tile_f32(sQ, ldt, qb + q0 * q_ss, q_ss, min(BQ32, S - q0), BQ32, D, Dp);
    for (int i = threadIdx.x; i < BQ32 * ldo; i += NTHREADS) sO[i] = 0.f;
    for (int i = threadIdx.x; i < BQ32; i += NTHREADS) { sM[i] = -1e30f; sL[i] = 0.f; }

    for (int k0 = 0; k0 < S; k0 += BK32) {
        const int nk = min(BK32, S - k0);
        load_tile_f32(sKV, ldt, kb + k0 * k_ss, k_ss, nk, BK32, D, Dp);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BQ32 * BK32; idx += NTHREADS) {
            const int r = idx / BK32, c = idx - r * BK32;
            float a = 0.f;
            for (int d = 0; d < D; ++d) a += sQ[r * ldt + d] * sKV[c * ldt + d];
            sS[r * lds + c] = a;
        }
        __syncthreads();
        online_softmax(sS, lds, sP, ldp, sM, sL, sC, BQ32, BK32, nk, scale);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BQ32 * Dp; idx += NTHREADS) {
            const int r = idx / Dp, d = idx - r * Dp;
            sO[r * ldo + d] *= sC[r];
        }
        load_tile_f32(sKV, ldt, vb + k0 * v_ss, v_ss, nk, BK32, D, Dp);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BQ32 * Dp; idx += NTHREADS) {
            const int r = idx / Dp, d = idx - r * Dp;
            float a = sO[r * ldo + d];
            for (int c = 0; c < BK32; ++c) a += sP[r * ldp + c] * sKV[c * ldt + d];
            sO[r * ldo + d] = a;
        }
        __syncthreads();
    }

    const int nq = min(BQ32, S - q0);
    for (int idx = threadIdx.x; idx < nq * D; idx += NTHREADS) {
        const int r = idx / D, d = idx - r * D;
        o[(((long long)b * S + q0 + r) * H + h) * D + d] = sO[r * ldo + d] / sL[r];
    }
    for (int r = threadIdx.x; r < nq; r += NTHREADS)
        lse[(long long)bh * S + q0 + r] = sM[r] + logf(sL[r]);
}

int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int S, int D, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss, float scale, cudaStream_t st) {
    const size_t smem = LayoutF32(D).total;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((S + BQ32 - 1) / BQ32, B * H);
    flash_fwd_f32<<<grid, NTHREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, S, D, q_sb, q_ss, k_sb,
        k_ss, v_sb, v_ss, scale);
    return (int)cudaGetLastError();
}

constexpr int MAX_NT = 12;  // bf16 instantiations cover D <= 64 * MAX_NT

size_t smem_bytes(int D, int dtype) {
    if (dtype == 1) return (D + 63) / 64 > MAX_NT ? ~size_t(0) : LayoutBf16(D, pick_bk(D)).total;
    return LayoutF32(D).total;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at head dim D (dtype 0 = f32, 1 = bf16).
long long medimgen_flash_attn_smem_bytes(int D, int dtype) { return (long long)smem_bytes(D, dtype); }

long long medimgen_flash_attn_smem_limit() { return (long long)MAX_SMEM; }

// q/k/v: element (b, s, h, d) at base + b*sb + s*ss + h*D + d.
// o: contiguous (B, S, H, D); lse: contiguous f32 (B*H, S).
// vec != 0 (bf16): every base pointer is 16-byte aligned and D and all
// strides are multiples of 8 elements. Returns the cudaError_t code.
int medimgen_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int H, int S, int D, int dtype,
                            long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                            long long v_sb, long long v_ss, float scale, int vec,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (smem_bytes(D, dtype) > MAX_SMEM || D < 1) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_f32(q, k, v, o, lse, B, H, S, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                          scale, st);
    if (dtype != 1) return (int)cudaErrorInvalidValue;
#define MEDIMGEN_NT(N, BK)                                                                    \
    case N:                                                                                   \
        return launch_bf16<N, BK>(q, k, v, o, lse, B, H, S, D, q_sb, q_ss, k_sb, k_ss, v_sb, \
                                  v_ss, scale, vec, st);
    switch ((D + 63) / 64) {
        MEDIMGEN_NT(1, 64) MEDIMGEN_NT(2, 64) MEDIMGEN_NT(3, 64) MEDIMGEN_NT(4, 64)
        MEDIMGEN_NT(5, 64) MEDIMGEN_NT(6, 64) MEDIMGEN_NT(7, 64) MEDIMGEN_NT(8, 64)
        MEDIMGEN_NT(9, 64) MEDIMGEN_NT(10, 64) MEDIMGEN_NT(11, 32) MEDIMGEN_NT(12, 32)
        default: return (int)cudaErrorInvalidValue;
    }
#undef MEDIMGEN_NT
}

}  // extern "C"
