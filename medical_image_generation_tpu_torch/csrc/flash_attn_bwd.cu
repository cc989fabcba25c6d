// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_bwd_fused_kernel` / `_flash_backward` in
// medical_image_generation_tpu/ops/pallas_attention.py (:187-358). From q, k, v,
// o, dO and the f32 row logsumexp `lse` (B*H, S) that the forward writes:
//
//   p = exp(scale q k^T - lse),  delta = rowsum(dO * o),
//   dv = p^T dO,  ds = scale p (dO v^T - delta),  dk = ds^T q,  dq = ds k.
//
// The TPU kernel walks K blocks and accumulates dq by a read-modify-write in
// HBM, which is safe only because the TPU grid runs in order (:199-202). CUDA
// blocks run in any order, so this is the deterministic two-pass form, with
// no atomics:
//   * dq kernel: a block owns 32 query rows and walks the K/V tiles. Its
//     prologue computes delta for its rows and writes it to (B*H, S) f32.
//   * dk/dv kernel (launched after it on the same stream): a block owns 16
//     keys and walks the Q/dO tiles, reading lse and delta.
// Both recompute q k^T and dO v^T, so the pair does 7 S^2 D matmuls where
// the fused form does 5; fusing the two needs atomics or a cluster
// reduction for dq.
//
// Bound on this card: operations, counted as the 5 S^2 D matmuls the math
// needs, 10*B*H*S^2*D FLOP at 989 TFLOP/s (bf16 tensor cores). The bytes
// (q, k, v, o, dO read once, dq, dk, dv written once) bound only the small
// (S = 512, D = 768) sites.
//
// Design (bf16, the model's path): tensor-core mma.sync m16n8k16 with f32
// accumulation, operands from shared memory by ldmatrix, as in
// flash_attn_fwd.cu. At head dims 512 and 768 an accumulator of 32 rows is
// 64-96 KB of f32, too much for one warp, so the 8 warps split the D axis:
// warp w keeps the columns [w*D/8, (w+1)*D/8) of every accumulator row in
// registers (dq: 32 rows; dk and dv: 16 rows each, so 2 x 16 rows fit the
// same registers). Score tiles (q k^T, dO v^T) are computed over the full D
// as 16x8 mma tiles, staged in shared memory in f32, turned into bf16 p / ds
// by all threads, and multiplied back. The dq kernel prefetches the next V
// tile with cp.async while it forms ds and multiplies by K; the dk/dv kernel
// loads each Q/dO tile synchronously (the two tiles fill its shared memory
// at D = 768). Tile sizes: dq kernel 32 queries x 64 keys while it fits the
// 227 KB of shared memory (D <= 512), else x 32; dk/dv kernel 16 keys x 64
// queries (D <= 640), else x 32. 16 keys a block keeps the dk and dv
// accumulators (2 x 16 rows) in the registers the dq kernel's 32 rows take,
// but each block then re-reads every Q and dO tile: the dk/dv pass moves
// S/16 times the bytes of q and dO, the first thing to change for speed.
//
// f32 (used to check the port against the CPU in fp32): the same two-pass
// tiling with scalar f32 FMAs and shared-memory accumulators.
//
// D is zero-padded in shared memory and ragged S is masked: padded keys and
// padded queries get p = ds = 0 and padded rows are never stored.
//
// Not yet: wgmma, TMA, warp specialisation, a persistent grid, fusing the
// two passes.

#include "flash_common.cuh"

namespace {

// ----------------------------------------------------------------- bf16 path

constexpr int BQA = 32;  // dq kernel: query rows per block
constexpr int BKB = 16;  // dk/dv kernel: key rows per block

struct LayoutDq {
    int Dp, ldt, lds, ldp;
    size_t off_do, off_k, off_v, off_s, off_dp, off_ds, off_stat, total;
    __host__ __device__ LayoutDq(int D, int BK) {
        Dp = (D + 63) & ~63;
        ldt = Dp + 8;  // +16 bytes a row: conflict-free ldmatrix
        lds = BK + 4;
        ldp = BK + 8;
        off_do = align128(sizeof(bf16) * BQA * ldt);
        off_k = off_do + align128(sizeof(bf16) * BQA * ldt);
        off_v = off_k + align128(sizeof(bf16) * BK * ldt);
        off_s = off_v + align128(sizeof(bf16) * BK * ldt);
        off_dp = off_s + align128(sizeof(float) * BQA * lds);
        off_ds = off_dp + align128(sizeof(float) * BQA * lds);
        off_stat = off_ds + align128(sizeof(bf16) * BQA * ldp);
        total = off_stat + align128(sizeof(float) * 2 * BQA);
    }
};

struct LayoutDkv {
    int Dp, ldt, lds, ldp;
    size_t off_v, off_q, off_do, off_s, off_dp, off_p, off_ds, off_stat, total;
    __host__ __device__ LayoutDkv(int D, int BQ) {
        Dp = (D + 63) & ~63;
        ldt = Dp + 8;
        lds = BQ + 4;
        ldp = BQ + 8;
        off_v = align128(sizeof(bf16) * BKB * ldt);
        off_q = off_v + align128(sizeof(bf16) * BKB * ldt);
        off_do = off_q + align128(sizeof(bf16) * BQ * ldt);
        off_s = off_do + align128(sizeof(bf16) * BQ * ldt);
        off_dp = off_s + align128(sizeof(float) * BKB * lds);
        off_p = off_dp + align128(sizeof(float) * BKB * lds);
        off_ds = off_p + align128(sizeof(bf16) * BKB * ldp);
        off_stat = off_ds + align128(sizeof(bf16) * BKB * ldp);
        total = off_stat + align128(sizeof(float) * 2 * BQ);
    }
};

int pick_dq_bk(int D) { return LayoutDq(D, 64).total <= MAX_SMEM ? 64 : 32; }
int pick_dkv_bq(int D) { return LayoutDkv(D, 64).total <= MAX_SMEM ? 64 : 32; }

// Scores of one m16 x n8 tile over the full (padded) head dim:
// acc += A[a_row0 .. +16, :] * B[b_row0 .. +8, :]^T, both row-major in smem.
__device__ __forceinline__ void score_tile(float (&acc)[4], const bf16* A, int a_row0,
                                           const bf16* Bm, int b_row0, int ldt, int Dp) {
    const int lane = threadIdx.x % 32;
    for (int kk = 0; kk < Dp / 16; ++kk) {
        unsigned a[4], b[2];
        ldsm_x4(a, A + (a_row0 + (lane % 16)) * ldt + kk * 16 + (lane / 16) * 8);
        ldsm_x2(b, Bm + (b_row0 + (lane % 8)) * ldt + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(acc, a, b);
    }
}

__device__ __forceinline__ void store_score(float* sS, int lds, int r0, int c0,
                                            const float (&v)[4]) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    *reinterpret_cast<float2*>(sS + (r0 + g) * lds + c0 + 2 * t) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(sS + (r0 + g + 8) * lds + c0 + 2 * t) = make_float2(v[2], v[3]);
}

// Store an m16 x (8*NT) accumulator slab (rows r0.., columns col0..) to a
// contiguous (B, S, H, D) bf16 tensor; rows >= nrows and columns >= D are skipped.
template <int NT>
__device__ __forceinline__ void store_acc(bf16* out, long long row0_off, long long row_stride,
                                          int r0, int nrows, int col0, int D,
                                          const float (&acc)[NT][4]) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        if (r >= nrows) continue;
        bf16* row = out + row0_off + r * row_stride;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int c = col0 + nt * 8 + 2 * t;
            if (c < D) row[c] = __float2bfloat16(acc[nt][2 * half]);
            if (c + 1 < D) row[c + 1] = __float2bfloat16(acc[nt][2 * half + 1]);
        }
    }
}

// dq for 32 query rows of one (batch, head); also writes delta for them.
// o, dO, dq: contiguous (B, S, H, D); q, k, v: element (b, s, h, d) at
// b*sb + s*ss + h*D + d.
template <int NT, int BK>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dO, const float* __restrict__ lse,
                  float* __restrict__ delta, bf16* __restrict__ dq, int H, int S, int D,
                  long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                  long long v_ss, float scale, bool vec) {
    constexpr int NPW = BK / 32;  // n8 score tiles per warp: 2 m16 x BK/8 tiles over 8 warps
    extern __shared__ __align__(128) unsigned char smem[];
    const LayoutDq L(D, BK);
    const int Dp = L.Dp, ldt = L.ldt, lds = L.lds, ldp = L.ldp;
    bf16* sQ = reinterpret_cast<bf16*>(smem);
    bf16* sdO = reinterpret_cast<bf16*>(smem + L.off_do);
    bf16* sK = reinterpret_cast<bf16*>(smem + L.off_k);
    bf16* sV = reinterpret_cast<bf16*>(smem + L.off_v);
    float* sS = reinterpret_cast<float*>(smem + L.off_s);
    float* sdP = reinterpret_cast<float*>(smem + L.off_dp);
    bf16* sdS = reinterpret_cast<bf16*>(smem + L.off_ds);
    float* sLse = reinterpret_cast<float*>(smem + L.off_stat);
    float* sDelta = sLse + BQA;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.x * BQA, nq = min(BQA, S - q0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long o_ss = (long long)H * D;
    const long long o_base = ((long long)b * S * H + h) * D;
    const bf16* qb = q + b * q_sb + (long long)h * D;
    const bf16* kb = k + b * k_sb + (long long)h * D;
    const bf16* vb = v + b * v_sb + (long long)h * D;
    const int ntiles = (S + BK - 1) / BK;

    load_tile_bf16(sQ, ldt, qb + q0 * q_ss, q_ss, nq, BQA, D, Dp, vec);
    load_tile_bf16(sdO, ldt, dO + o_base + q0 * o_ss, o_ss, nq, BQA, D, Dp, vec);
    load_tile_bf16(sK, ldt, kb, k_ss, min(BK, S), BK, D, Dp, vec);
    load_tile_bf16(sV, ldt, vb, v_ss, min(BK, S), BK, D, Dp, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // delta = rowsum(dO * o) for this block's rows, one warp per row
    for (int r = warp; r < BQA; r += NWARPS) {
        float acc = 0.f;
        if (r < nq) {
            const bf16* orow = o + o_base + (q0 + r) * o_ss;
            for (int c = lane; c < D; c += 32)
                acc += __bfloat162float(orow[c]) * __bfloat162float(sdO[r * ldt + c]);
        }
        acc = warp_sum(acc);
        if (lane == 0) {
            sDelta[r] = acc;
            sLse[r] = r < nq ? lse[(long long)bh * S + q0 + r] : 0.f;
            if (r < nq) delta[(long long)bh * S + q0 + r] = acc;
        }
    }

    float acc[2][NT][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

    const int col0 = warp * 8 * NT;
    for (int j = 0; j < ntiles; ++j) {
        const int k0 = j * BK, nk = min(BK, S - k0);
        const bool more = j + 1 < ntiles;
        cp_async_wait<0>();  // this K and V tile landed
        __syncthreads();

        {  // S = Q K^T and dP = dO V^T: warp (mi, n tiles nb..nb+NPW-1)
            const int mi = warp & 1, nb = (warp >> 1) * NPW;
#pragma unroll
            for (int i = 0; i < NPW; ++i) {
                float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
                score_tile(sc, sQ, mi * 16, sK, (nb + i) * 8, ldt, Dp);
                score_tile(dp, sdO, mi * 16, sV, (nb + i) * 8, ldt, Dp);
                store_score(sS, lds, mi * 16, (nb + i) * 8, sc);
                store_score(sdP, lds, mi * 16, (nb + i) * 8, dp);
            }
        }
        __syncthreads();  // V tile consumed: start the next one
        if (more) {
            load_tile_bf16(sV, ldt, vb + (k0 + BK) * v_ss, v_ss, min(BK, S - k0 - BK), BK, D,
                           Dp, vec);
            cp_async_commit();
        }

        // ds = scale * p * (dP - delta), p = exp(scale * s - lse), in bf16
        for (int idx = threadIdx.x; idx < BQA * BK; idx += NTHREADS) {
            const int r = idx / BK, c = idx - r * BK;
            float ds = 0.f;
            if (r < nq && c < nk) {
                const float p = expf(sS[r * lds + c] * scale - sLse[r]);
                ds = scale * p * (sdP[r * lds + c] - sDelta[r]);
            }
            sdS[r * ldp + c] = __float2bfloat16(ds);
        }
        __syncthreads();

        // dQ += dS K on this warp's columns
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            unsigned a0[4], a1[4];
            ldsm_x4(a0, sdS + (lane % 16) * ldp + kk * 16 + (lane / 16) * 8);
            ldsm_x4(a1, sdS + (16 + lane % 16) * ldp + kk * 16 + (lane / 16) * 8);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                unsigned bfr[2];
                ldsm_x2_trans(bfr, sK + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ldt +
                                       col0 + nt * 8);
                mma_bf16(acc[0][nt], a0, bfr);
                mma_bf16(acc[1][nt], a1, bfr);
            }
        }
        __syncthreads();  // K tile consumed: start the next one
        if (more) {
            load_tile_bf16(sK, ldt, kb + (k0 + BK) * k_ss, k_ss, min(BK, S - k0 - BK), BK, D,
                           Dp, vec);
            cp_async_commit();
        }
    }

    const long long dq_off = o_base + q0 * o_ss;
    store_acc<NT>(dq, dq_off, o_ss, 0, nq, col0, D, acc[0]);
    store_acc<NT>(dq, dq_off, o_ss, 16, nq, col0, D, acc[1]);
}

// dk, dv for 16 keys of one (batch, head), walking all queries. Reads the
// delta the dq kernel wrote.
template <int NT, int BQ>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S, int D,
                    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                    long long v_sb, long long v_ss, float scale, bool vec) {
    constexpr int NQ8 = BQ / 8;  // n8 score tiles of one matrix
    extern __shared__ __align__(128) unsigned char smem[];
    const LayoutDkv L(D, BQ);
    const int Dp = L.Dp, ldt = L.ldt, lds = L.lds, ldp = L.ldp;
    bf16* sK = reinterpret_cast<bf16*>(smem);
    bf16* sV = reinterpret_cast<bf16*>(smem + L.off_v);
    bf16* sQ = reinterpret_cast<bf16*>(smem + L.off_q);
    bf16* sdO = reinterpret_cast<bf16*>(smem + L.off_do);
    float* sS = reinterpret_cast<float*>(smem + L.off_s);
    float* sdP = reinterpret_cast<float*>(smem + L.off_dp);
    bf16* sP = reinterpret_cast<bf16*>(smem + L.off_p);
    bf16* sdS = reinterpret_cast<bf16*>(smem + L.off_ds);
    float* sLse = reinterpret_cast<float*>(smem + L.off_stat);
    float* sDelta = sLse + BQ;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int k0 = blockIdx.x * BKB, nk = min(BKB, S - k0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long o_ss = (long long)H * D;
    const long long o_base = ((long long)b * S * H + h) * D;
    const bf16* qb = q + b * q_sb + (long long)h * D;
    const bf16* kb = k + b * k_sb + (long long)h * D;
    const bf16* vb = v + b * v_sb + (long long)h * D;

    load_tile_bf16(sK, ldt, kb + k0 * k_ss, k_ss, nk, BKB, D, Dp, vec);
    load_tile_bf16(sV, ldt, vb + k0 * v_ss, v_ss, nk, BKB, D, Dp, vec);

    float adk[NT][4], adv[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

    const int col0 = warp * 8 * NT;
    for (int i0 = 0; i0 < S; i0 += BQ) {
        const int nq = min(BQ, S - i0);
        load_tile_bf16(sQ, ldt, qb + i0 * q_ss, q_ss, nq, BQ, D, Dp, vec);
        load_tile_bf16(sdO, ldt, dO + o_base + i0 * o_ss, o_ss, nq, BQ, D, Dp, vec);
        cp_async_commit();
        for (int c = threadIdx.x; c < BQ; c += NTHREADS) {
            sLse[c] = c < nq ? lse[(long long)bh * S + i0 + c] : 0.f;
            sDelta[c] = c < nq ? delta[(long long)bh * S + i0 + c] : 0.f;
        }
        cp_async_wait<0>();
        __syncthreads();

        // S^T = K Q^T and dP^T = V dO^T (16 x BQ each), one n8 tile a task
        for (int task = warp; task < 2 * NQ8; task += NWARPS) {
            const bool is_dp = task >= NQ8;
            const int n = is_dp ? task - NQ8 : task;
            float sc[4] = {0.f, 0.f, 0.f, 0.f};
            score_tile(sc, is_dp ? sV : sK, 0, is_dp ? sdO : sQ, n * 8, ldt, Dp);
            store_score(is_dp ? sdP : sS, lds, 0, n * 8, sc);
        }
        __syncthreads();

        // p^T and ds^T in bf16; padded keys or queries give 0
        for (int idx = threadIdx.x; idx < BKB * BQ; idx += NTHREADS) {
            const int r = idx / BQ, c = idx - r * BQ;
            float p = 0.f, ds = 0.f;
            if (r < nk && c < nq) {
                p = expf(sS[r * lds + c] * scale - sLse[c]);
                ds = scale * p * (sdP[r * lds + c] - sDelta[c]);
            }
            sP[r * ldp + c] = __float2bfloat16(p);
            sdS[r * ldp + c] = __float2bfloat16(ds);
        }
        __syncthreads();

        // dV += P^T dO, dK += dS^T Q on this warp's columns
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
            unsigned ap[4], ads[4];
            ldsm_x4(ap, sP + (lane % 16) * ldp + kk * 16 + (lane / 16) * 8);
            ldsm_x4(ads, sdS + (lane % 16) * ldp + kk * 16 + (lane / 16) * 8);
            const int trow = kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                unsigned bdo[2], bq[2];
                ldsm_x2_trans(bdo, sdO + trow * ldt + col0 + nt * 8);
                ldsm_x2_trans(bq, sQ + trow * ldt + col0 + nt * 8);
                mma_bf16(adv[nt], ap, bdo);
                mma_bf16(adk[nt], ads, bq);
            }
        }
        __syncthreads();  // Q / dO tiles consumed before the next load
    }

    const long long off = o_base + k0 * o_ss;
    store_acc<NT>(dk, off, o_ss, 0, nk, col0, D, adk);
    store_acc<NT>(dv, off, o_ss, 0, nk, col0, D, adv);
}

struct Args {
    const void *q, *k, *v, *o, *dO;
    const float* lse;
    float* delta;
    void *dq, *dk, *dv;
    int B, H, S, D;
    long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
    float scale;
    bool vec;
    cudaStream_t st;
};

template <int NT, int BK>
int launch_dq_bf16(const Args& a) {
    const size_t smem = LayoutDq(a.D, BK).total;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16<NT, BK>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.S + BQA - 1) / BQA, a.B * a.H);
    flash_bwd_dq_bf16<NT, BK><<<grid, NTHREADS, smem, a.st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
        static_cast<const bf16*>(a.dO), a.lse, a.delta, static_cast<bf16*>(a.dq), a.H, a.S,
        a.D, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale, a.vec);
    return (int)cudaGetLastError();
}

template <int NT, int BQ>
int launch_dkdv_bf16(const Args& a) {
    const size_t smem = LayoutDkv(a.D, BQ).total;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16<NT, BQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((a.S + BKB - 1) / BKB, a.B * a.H);
    flash_bwd_dkdv_bf16<NT, BQ><<<grid, NTHREADS, smem, a.st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dO), a.lse, a.delta,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.S, a.D, a.q_sb, a.q_ss,
        a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale, a.vec);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ f32 path

constexpr int BQ32 = 16;   // dq kernel: queries a block, keys a tile
constexpr int BK32 = 8;    // dk/dv kernel: keys a block (queries a tile: BQ32)

struct LayoutF32 {
    int Dp, ldt;
    size_t dq_total, dkv_total;
    __host__ __device__ explicit LayoutF32(int D) {
        Dp = (D + 3) & ~3;
        ldt = Dp + 4;
        const size_t tile16 = align128(sizeof(float) * BQ32 * ldt);
        const size_t tile8 = align128(sizeof(float) * BK32 * ldt);
        const size_t small = align128(sizeof(float) * 3 * BQ32 * (BQ32 + 1)) +
                             align128(sizeof(float) * 2 * BQ32);
        dq_total = 4 * tile16 + small;             // Q, dO, K-or-V, dQ accumulator
        dkv_total = 2 * tile16 + 4 * tile8 + small;  // Q, dO; K, V, dK, dV accumulators
    }
};

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dO, const float* __restrict__ lse,
                 float* __restrict__ delta, float* __restrict__ dq, int H, int S, int D,
                 long long q_sb, long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                 long long v_ss, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const LayoutF32 L(D);
    const int Dp = L.Dp, ldt = L.ldt, lds = BQ32 + 1;
    const size_t tile = align128(sizeof(float) * BQ32 * ldt);
    float* sQ = reinterpret_cast<float*>(smem);
    float* sdO = reinterpret_cast<float*>(smem + tile);
    float* sKV = reinterpret_cast<float*>(smem + 2 * tile);
    float* sAcc = reinterpret_cast<float*>(smem + 3 * tile);
    float* sS = reinterpret_cast<float*>(smem + 4 * tile);
    float* sdP = sS + BQ32 * lds;
    float* sdS = sdP + BQ32 * lds;
    float* sLse = reinterpret_cast<float*>(smem + 4 * tile +
                                           align128(sizeof(float) * 3 * BQ32 * lds));
    float* sDelta = sLse + BQ32;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.x * BQ32, nq = min(BQ32, S - q0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long o_ss = (long long)H * D;
    const long long o_base = ((long long)b * S * H + h) * D;
    const float* qb = q + b * q_sb + (long long)h * D;
    const float* kb = k + b * k_sb + (long long)h * D;
    const float* vb = v + b * v_sb + (long long)h * D;

    load_tile_f32(sQ, ldt, qb + q0 * q_ss, q_ss, nq, BQ32, D, Dp);
    load_tile_f32(sdO, ldt, dO + o_base + q0 * o_ss, o_ss, nq, BQ32, D, Dp);
    for (int i = threadIdx.x; i < BQ32 * ldt; i += NTHREADS) sAcc[i] = 0.f;
    __syncthreads();
    for (int r = warp; r < BQ32; r += NWARPS) {
        float acc = 0.f;
        if (r < nq) {
            const float* orow = o + o_base + (q0 + r) * o_ss;
            for (int c = lane; c < D; c += 32) acc += orow[c] * sdO[r * ldt + c];
        }
        acc = warp_sum(acc);
        if (lane == 0) {
            sDelta[r] = acc;
            sLse[r] = r < nq ? lse[(long long)bh * S + q0 + r] : 0.f;
            if (r < nq) delta[(long long)bh * S + q0 + r] = acc;
        }
    }

    for (int k0 = 0; k0 < S; k0 += BQ32) {
        const int nk = min(BQ32, S - k0);
        __syncthreads();
        load_tile_f32(sKV, ldt, vb + k0 * v_ss, v_ss, nk, BQ32, D, Dp);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BQ32 * BQ32; idx += NTHREADS) {
            const int r = idx / BQ32, c = idx - r * BQ32;
            float a = 0.f;
            for (int d = 0; d < D; ++d) a += sdO[r * ldt + d] * sKV[c * ldt + d];
            sdP[r * lds + c] = a;
        }
        __syncthreads();
        load_tile_f32(sKV, ldt, kb + k0 * k_ss, k_ss, nk, BQ32, D, Dp);
        __syncthreads();
        for (int idx = threadIdx.x; idx < BQ32 * BQ32; idx += NTHREADS) {
            const int r = idx / BQ32, c = idx - r * BQ32;
            float a = 0.f;
            for (int d = 0; d < D; ++d) a += sQ[r * ldt + d] * sKV[c * ldt + d];
            float ds = 0.f;
            if (r < nq && c < nk) {
                const float p = expf(a * scale - sLse[r]);
                ds = scale * p * (sdP[r * lds + c] - sDelta[r]);
            }
            sdS[r * lds + c] = ds;
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < BQ32 * Dp; idx += NTHREADS) {
            const int r = idx / Dp, d = idx - r * Dp;
            float a = sAcc[r * ldt + d];
            for (int c = 0; c < BQ32; ++c) a += sdS[r * lds + c] * sKV[c * ldt + d];
            sAcc[r * ldt + d] = a;
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * D; idx += NTHREADS) {
        const int r = idx / D, d = idx - r * D;
        dq[o_base + (q0 + r) * o_ss + d] = sAcc[r * ldt + d];
    }
}

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int H, int S, int D,
                   long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                   long long v_sb, long long v_ss, float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    const LayoutF32 L(D);
    const int Dp = L.Dp, ldt = L.ldt, lds = BQ32 + 1;
    const size_t t16 = align128(sizeof(float) * BQ32 * ldt);
    const size_t t8 = align128(sizeof(float) * BK32 * ldt);
    float* sQ = reinterpret_cast<float*>(smem);
    float* sdO = reinterpret_cast<float*>(smem + t16);
    float* sK = reinterpret_cast<float*>(smem + 2 * t16);
    float* sV = reinterpret_cast<float*>(smem + 2 * t16 + t8);
    float* sdK = reinterpret_cast<float*>(smem + 2 * t16 + 2 * t8);
    float* sdV = reinterpret_cast<float*>(smem + 2 * t16 + 3 * t8);
    float* sP = reinterpret_cast<float*>(smem + 2 * t16 + 4 * t8);
    float* sdS = sP + BQ32 * lds;
    float* sLse = reinterpret_cast<float*>(smem + 2 * t16 + 4 * t8 +
                                           align128(sizeof(float) * 3 * BQ32 * lds));
    float* sDelta = sLse + BQ32;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int k0 = blockIdx.x * BK32, nk = min(BK32, S - k0);
    const long long o_ss = (long long)H * D;
    const long long o_base = ((long long)b * S * H + h) * D;
    const float* qb = q + b * q_sb + (long long)h * D;
    const float* kb = k + b * k_sb + (long long)h * D;
    const float* vb = v + b * v_sb + (long long)h * D;

    load_tile_f32(sK, ldt, kb + k0 * k_ss, k_ss, nk, BK32, D, Dp);
    load_tile_f32(sV, ldt, vb + k0 * v_ss, v_ss, nk, BK32, D, Dp);
    for (int i = threadIdx.x; i < BK32 * ldt; i += NTHREADS) { sdK[i] = 0.f; sdV[i] = 0.f; }

    for (int i0 = 0; i0 < S; i0 += BQ32) {
        const int nq = min(BQ32, S - i0);
        __syncthreads();
        load_tile_f32(sQ, ldt, qb + i0 * q_ss, q_ss, nq, BQ32, D, Dp);
        load_tile_f32(sdO, ldt, dO + o_base + i0 * o_ss, o_ss, nq, BQ32, D, Dp);
        for (int c = threadIdx.x; c < BQ32; c += NTHREADS) {
            sLse[c] = c < nq ? lse[(long long)bh * S + i0 + c] : 0.f;
            sDelta[c] = c < nq ? delta[(long long)bh * S + i0 + c] : 0.f;
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < BK32 * BQ32; idx += NTHREADS) {
            const int r = idx / BQ32, c = idx - r * BQ32;
            float s = 0.f, dp = 0.f;
            for (int d = 0; d < D; ++d) {
                s += sK[r * ldt + d] * sQ[c * ldt + d];
                dp += sV[r * ldt + d] * sdO[c * ldt + d];
            }
            float p = 0.f, ds = 0.f;
            if (r < nk && c < nq) {
                p = expf(s * scale - sLse[c]);
                ds = scale * p * (dp - sDelta[c]);
            }
            sP[r * lds + c] = p;
            sdS[r * lds + c] = ds;
        }
        __syncthreads();
        for (int idx = threadIdx.x; idx < BK32 * Dp; idx += NTHREADS) {
            const int r = idx / Dp, d = idx - r * Dp;
            float a = sdV[r * ldt + d], bk = sdK[r * ldt + d];
            for (int c = 0; c < BQ32; ++c) {
                a += sP[r * lds + c] * sdO[c * ldt + d];
                bk += sdS[r * lds + c] * sQ[c * ldt + d];
            }
            sdV[r * ldt + d] = a;
            sdK[r * ldt + d] = bk;
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nk * D; idx += NTHREADS) {
        const int r = idx / D, d = idx - r * D;
        const long long at = o_base + (k0 + r) * o_ss + d;
        dk[at] = sdK[r * ldt + d];
        dv[at] = sdV[r * ldt + d];
    }
}

int launch_f32(const Args& a, bool dq_pass) {
    const LayoutF32 L(a.D);
    const size_t smem = dq_pass ? L.dq_total : L.dkv_total;
    const void* fn = dq_pass ? (const void*)flash_bwd_dq_f32 : (const void*)flash_bwd_dkdv_f32;
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
                *v = static_cast<const float*>(a.v), *dO = static_cast<const float*>(a.dO);
    if (dq_pass) {
        const dim3 grid((a.S + BQ32 - 1) / BQ32, a.B * a.H);
        flash_bwd_dq_f32<<<grid, NTHREADS, smem, a.st>>>(
            q, k, v, static_cast<const float*>(a.o), dO, a.lse, a.delta,
            static_cast<float*>(a.dq), a.H, a.S, a.D, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb,
            a.v_ss, a.scale);
    } else {
        const dim3 grid((a.S + BK32 - 1) / BK32, a.B * a.H);
        flash_bwd_dkdv_f32<<<grid, NTHREADS, smem, a.st>>>(
            q, k, v, dO, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
            a.H, a.S, a.D, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale);
    }
    return (int)cudaGetLastError();
}

constexpr int MAX_NT = 12;  // bf16 instantiations cover D <= 64 * MAX_NT

size_t smem_bytes(int D, int dtype) {
    if (dtype == 1) {
        if ((D + 63) / 64 > MAX_NT) return ~size_t(0);
        const size_t a = LayoutDq(D, pick_dq_bk(D)).total;
        const size_t b = LayoutDkv(D, pick_dkv_bq(D)).total;
        return a > b ? a : b;
    }
    const LayoutF32 L(D);
    return L.dq_total > L.dkv_total ? L.dq_total : L.dkv_total;
}

// The tile sizes follow from NT alone (the padded head dim is 64 * NT), so one
// instantiation per NT: the dq kernel's 64-key tiles fit the 227 KB up to
// NT = 8 (D <= 512), the dk/dv kernel's 64-query tiles up to NT = 10.
template <int NT>
int launch_bf16(const Args& a, bool dq_pass) {
    constexpr int BK = NT <= 8 ? 64 : 32, BQ = NT <= 10 ? 64 : 32;
    if (pick_dq_bk(a.D) != BK || pick_dkv_bq(a.D) != BQ) return (int)cudaErrorInvalidValue;
    return dq_pass ? launch_dq_bf16<NT, BK>(a) : launch_dkdv_bf16<NT, BQ>(a);
}

int run(const Args& a, int dtype, bool dq_pass) {
    if (a.D < 1 || smem_bytes(a.D, dtype) > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch_f32(a, dq_pass);
    if (dtype != 1) return (int)cudaErrorInvalidValue;
#define MEDIMGEN_NT(N) \
    case N: return launch_bf16<N>(a, dq_pass);
    switch ((a.D + 63) / 64) {
        MEDIMGEN_NT(1) MEDIMGEN_NT(2) MEDIMGEN_NT(3) MEDIMGEN_NT(4) MEDIMGEN_NT(5)
        MEDIMGEN_NT(6) MEDIMGEN_NT(7) MEDIMGEN_NT(8) MEDIMGEN_NT(9) MEDIMGEN_NT(10)
        MEDIMGEN_NT(11) MEDIMGEN_NT(12)
        default: return (int)cudaErrorInvalidValue;
    }
#undef MEDIMGEN_NT
}

}  // namespace

extern "C" {

// Dynamic shared memory the larger of the two kernels needs at head dim D
// (dtype 0 = f32, 1 = bf16).
long long medimgen_flash_attn_bwd_smem_bytes(int D, int dtype) {
    return (long long)smem_bytes(D, dtype);
}

// q/k/v: element (b, s, h, d) at base + b*sb + s*ss + h*D + d. o, dO and the
// outputs dq, dk, dv: contiguous (B, S, H, D) of q's dtype; lse, delta:
// contiguous f32 (B*H, S). vec != 0 (bf16): every base pointer is 16-byte
// aligned and D and all strides are multiples of 8 elements.
// The dq pass writes dq and delta; the dk/dv pass reads delta and must run
// after it on the same stream. Each returns the cudaError_t code.
int medimgen_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dO, const float* lse, float* delta, void* dq,
                               int B, int H, int S, int D, int dtype, long long q_sb,
                               long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                               long long v_ss, float scale, int vec, void* stream) {
    const Args a{q, k, v, o, dO, lse, delta, dq, nullptr, nullptr, B, H, S, D, q_sb, q_ss,
                 k_sb, k_ss, v_sb, v_ss, scale, vec != 0, static_cast<cudaStream_t>(stream)};
    return run(a, dtype, true);
}

int medimgen_flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dO,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 int B, int H, int S, int D, int dtype, long long q_sb,
                                 long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                                 long long v_ss, float scale, int vec, void* stream) {
    const Args a{q, k, v, nullptr, dO, lse, const_cast<float*>(delta), nullptr, dk, dv, B, H,
                 S, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, vec != 0,
                 static_cast<cudaStream_t>(stream)};
    return run(a, dtype, false);
}

}  // extern "C"
