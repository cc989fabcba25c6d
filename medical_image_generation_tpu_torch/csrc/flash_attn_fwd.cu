// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_kernel` / `_flash_forward` in
// medical_image_generation_tpu/ops/pallas_attention.py (:61-184): softmax(scale * Q K^T) V
// over (B*H, Sq, D) queries and (B*H, Sk, D) keys and values with an online
// softmax across K tiles, f32 running max m, f32 running sum l and an f32
// output accumulator, and no Sq x Sk buffer. It writes O (input dtype, Sq
// rows) and the f32 row logsumexp (B*H, Sq) that a backward pass consumes.
// The TPU kernel takes one S for q, k and v; here Sk is its own length (a
// cross-attention context of 1 or 77 tokens, or longer than Sq).
//
// Bound on this card: 4*B*H*Sq*Sk*D FLOP at 989 TFLOP/s (bf16 tensor cores)
// against the bytes (Q, K, V read once, O and lse written once) at 3.35 TB/s.
// Operations bound self-attention at the U-Net's shapes (Sq = Sk = 4096, D =
// 512; the bytes are ~1% of that time); bytes bound a short context (Sk =
// 77), and every key tile past Sk is a tile of zeros and masked scores.
//
// Design (bf16, the model's path). The TPU kernel walks K blocks inside one
// grid step; here a CTA, or a cluster of n CTAs, owns 64 query rows of one
// (batch, head) and walks K/V tiles of 32 keys, so blocks are independent.
//   * Registers decide the shape. The f32 O accumulator of 64 rows is 64 x D
//     floats (49,152 registers at D = 768), so the head dim is split: each
//     CTA holds two consumer warpgroups, and warpgroup w of CTA rank r owns
//     the 64-column chunks [(2r + w)*CPC, (2r + w + 1)*CPC) of Q, K, V and O
//     (CPC <= 4: at most 128 accumulator floats a thread). n = 1 up to
//     D = 512 (CPC = 4 at 512), n = 2 above (CPC = 3 at 768, the largest D
//     taken).
//   * Each warpgroup computes a partial score tile Q_w K_w^T (64 x 32, f32)
//     over its columns with wgmma (m64n32k16, both operands K-major from
//     shared memory). The 2n partials are summed in one fixed order, (rank,
//     warpgroup), by every warpgroup: through shared memory inside the CTA
//     (a named barrier when n = 1) and through DSMEM across the cluster
//     (mbarrier arrivals at cluster scope, ld.shared::cluster). Every
//     warpgroup then holds the same bits, so they agree on m and l. Slots
//     are double-buffered: one barrier a tile.
//   * The softmax runs in registers: row max and sum over the 4 threads of a
//     quad (shuffles), exp2 with the scale folded into log2 units. P goes
//     from the score accumulator straight into the register A operand of the
//     P V wgmma (m64nNk16, N = 64*CPC) after conversion to bf16; V is read
//     MN-major from shared memory, so nothing is transposed.
//   * One producer warpgroup (one thread) loads Q once and K/V tiles through
//     TMA (cp.async.bulk.tensor, 128-byte swizzle, zero fill outside Sq, Sk and D)
//     into a ring of 2 stages, completing on mbarriers; consumers release a
//     stage with an arrival of each thread. setmaxnreg moves registers from
//     the producer (24) to the consumers (240).
//   * Ragged lengths: keys past Sk get score -inf (a context shorter than
//     one 32-key tile is one partial tile: TMA zero-fills K and V past Sk),
//     query rows past Sq are not stored;
//     D is padded with TMA's zero fill, and the wrapper copies inputs TMA
//     cannot describe (misaligned base, strides or D not multiples of 8).
// Shared memory at D = 512: Q 64 KB, two K/V stages 128 KB, partial slots
// 32 KB.
//
// f32 (used to check the port against the CPU in fp32): scalar f32 FMAs with
// a shared-memory accumulator, BQ = BK = 16, any D it fits.
//
// Not yet: overlapping one tile's softmax and exchange with the next tile's
// Q K^T (two score accumulators), ping-pong between warpgroups on different
// row blocks, a persistent grid, TMA stores of O.

#include "flash_common.cuh"

namespace {

// Online softmax over one score tile: sS (BQ x BK f32, unscaled) -> sP
// (probabilities), updating the running max sM and sum sL and writing the
// accumulator correction sC = exp(m_old - m_new). One warp per row; BK <= 64.
// (The f32 path; the bf16 kernel keeps its softmax in registers.)
__device__ void online_softmax(const float* sS, int lds, float* sP, int ldp, float* sM, float* sL,
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
            if (c < BK) sP[r * ldp + c] = p;
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

constexpr int FWD_STAGES = 2;     // K/V ring depth

struct FwdLayout {
    unsigned q, kv, slots, bars, total;
    __host__ __device__ explicit FwdLayout(int cpc) {
        q = 0;                                          // warpgroup w's Q chunks at w*cpc boxes
        kv = q + 2 * cpc * BOX_BYTES;                   // stage s: K at +0, V at +2*cpc tiles
        slots = kv + FWD_STAGES * 4 * cpc * TBOX_BYTES; // [2 buffers][2 warpgroups] partials
        bars = slots + 4 * SLOT_F4 * 16;                // full[2], empty[2], ready[2], q
        total = bars + 7 * 8 + 1024;                    // + alignment slack
    }
};

// One CTA of an n-CTA cluster: 64 query rows of one (batch, head). Warpgroup
// w of CTA rank r owns head-dim chunks [(2r + w)*CPC, (2r + w + 1)*CPC); warp
// 8 loads.
template <int CPC, bool CLUSTER>  // CLUSTER: n > 1
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
               float* __restrict__ lse, int H, int Sq, int Sk, int D, int n, float scale_log2) {
    constexpr int NACC = CPC * 32;  // O accumulator floats a thread (64 x 64*CPC)
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    const FwdLayout L(CPC);
    float4* slots = reinterpret_cast<float4*>(smem + L.slots);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
    uint64_t* empty = full + 2;
    uint64_t* ready = full + 4;
    uint64_t* qbar = full + 6;

    const unsigned rank = cluster_ctarank();
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int q0 = (blockIdx.x / n) * BOX;
    const int col0 = rank * 2 * CPC * BOX;  // this CTA's first head-dim column
    const int ntiles = (Sk + TILE - 1) / TILE;

    if (threadIdx.x == 0) {
        for (int s = 0; s < 2; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
            mbar_init(&ready[s], 2 * n);
        }
        mbar_init(qbar, 1);
        mbar_init_fence();
    }
    __syncthreads();
    if (CLUSTER) cluster_sync();  // every CTA's barriers exist before any remote arrive

    // warp-uniform role, so that setmaxnreg can size each branch
    const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (role == 2) {  // ---- producer warpgroup: one thread feeds the K/V ring
        producer_regs();
        if (threadIdx.x == 256) {
            mbar_expect_tx(qbar, 2 * CPC * BOX_BYTES);
#pragma unroll 1
            for (int c = 0; c < 2 * CPC; ++c)
                tma_load_box(smem + L.q + c * BOX_BYTES, &mq, col0 + c * BOX, h, q0, b, qbar);
        }
        auto load_tile = [&](int j) {
            const int s = j % FWD_STAGES;
            if (j >= FWD_STAGES) mbar_wait(&empty[s], ((j / FWD_STAGES) - 1) & 1);
            unsigned char* sK = smem + L.kv + s * 4 * CPC * TBOX_BYTES;
            unsigned char* sV = sK + 2 * CPC * TBOX_BYTES;
            mbar_expect_tx(&full[s], 4 * CPC * TBOX_BYTES);
#pragma unroll 1
            for (int c = 0; c < 2 * CPC; ++c) {
                const int d0 = col0 + c * BOX, k0 = j * TILE;
                tma_load_box(sK + c * TBOX_BYTES, &mk, d0, h, k0, b, &full[s]);
                tma_load_box(sV + c * TBOX_BYTES, &mv, d0, h, k0, b, &full[s]);
            }
        };
        if (threadIdx.x == 256) {
#pragma unroll 1
            for (int j = 0; j < ntiles; ++j) load_tile(j);
        }
        if (CLUSTER) cluster_sync();  // matches the consumers' final cluster barrier
    } else {  // ---- consumer warpgroups
        consumer_regs();
        const int wg = role, t = threadIdx.x % 128;
        const int w = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
        const unsigned char* sQ = smem + L.q + wg * CPC * BOX_BYTES;
        float acc[NACC];
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        mbar_wait(qbar, 0);

        for (int j = 0; j < ntiles; ++j) {
            const int s = j % FWD_STAGES, buf = j & 1;
            const unsigned char* sK = smem + L.kv + (4 * s + wg) * CPC * TBOX_BYTES;
            const unsigned char* sV = sK + 2 * CPC * TBOX_BYTES;
            mbar_wait(&full[s], (j / FWD_STAGES) & 1);

            // partial scores over this warpgroup's head-dim columns: Q_w K_w^T
            float sc[16];
            wgmma_fence();
#pragma unroll
            for (int c = 0; c < CPC; ++c)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_m64n32k16_ss(sc, kmajor_desc(sQ + c * BOX_BYTES + kk * 32),
                                       kmajor_desc(sK + c * TBOX_BYTES + kk * 32), c + kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_operand(sc);

            // sum the 2n partials of the cluster, in the order (rank, warpgroup)
            float4* mine = slots + (2 * buf + wg) * SLOT_F4;
            slot_store(mine, sc, t);
            if (CLUSTER) {
                slot_publish(&ready[buf], wg, t, n);
                slot_wait(&ready[buf], (j >> 1) & 1, wg, t);
            } else {
                named_bar_sync(3, 256);  // both warpgroups' partials are in place
            }
            for (int r = 0; r < (CLUSTER ? n : 1); ++r)
#pragma unroll
                for (int v = 0; v < 2; ++v)
                    slot_add(sc, slots + (2 * buf + v) * SLOT_F4, t, r, CLUSTER, r + v == 0);

            // online softmax in registers (log2 units); rows g and g + 8 of warp w
            const int k0 = j * TILE;
            if (k0 + TILE > Sk) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (k0 + 8 * i + 2 * tq + (e & 1) >= Sk) sc[4 * i + e] = -INFINITY;
            }
            float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int i = 0; i < 16; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
            float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                const float m_new = fmaxf(m[r], mx[r] * scale_log2);
                corr[r] = exp2f(m[r] - m_new);
                m[r] = m_new;
            }
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const int r = (i >> 1) & 1;
                sc[i] = exp2f(fmaf(sc[i], scale_log2, -m[r]));
                ls[r] += sc[i];
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
                ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
                l[r] = l[r] * corr[r] + ls[r];
            }

            // O = O * corr + P V_w, P straight from registers
            unsigned a[2][4];
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) acc_to_a(a[kk], sc, kk);
            fence_operand(acc);
#pragma unroll
            for (int i = 0; i < NACC; ++i) acc[i] *= corr[(i >> 1) & 1];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
                wgmma_m64k16_rs(acc, a[kk], mnmajor_desc(sV + kk * 16 * 128, TBOX_BYTES));
            wgmma_commit();
            wgmma_wait<0>();
            fence_operand(acc);
            mbar_arrive(&empty[s]);
        }

        // O = acc / l into (B, Sq, H, D); lse = m + log(l) into (B*H, Sq)
        const int wcol0 = col0 + wg * CPC * BOX;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = q0 + 16 * w + g + 8 * r;
            if (row >= Sq) continue;
            const float inv = 1.f / l[r];
            bf16* orow = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i) {
                const int c = wcol0 + 8 * i + 2 * tq;
                if (c < D)
                    *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
                        acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
            }
            if (rank == 0 && wg == 0 && tq == 0)
                lse[(long long)bh * Sq + row] = (m[r] + log2f(l[r])) * LN2;
        }
        if (CLUSTER) cluster_sync();  // no CTA leaves while a peer may read its slots
    }
}

template <int CPC, bool CLUSTER>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int Sq, int Sk, int D, long long q_sb, long long q_ss, long long k_sb,
                long long k_ss, long long v_sb, long long v_ss, float scale, int n,
                cudaStream_t st) {
    CUtensorMap mq, mk, mv;
    int err = make_map_bshd(&mq, q, B, H, Sq, D, q_sb, q_ss, BOX);
    if (!err) err = make_map_bshd(&mk, k, B, H, Sk, D, k_sb, k_ss, TILE);
    if (!err) err = make_map_bshd(&mv, v, B, H, Sk, D, v_sb, v_ss, TILE);
    if (err) return err;
    const unsigned smem = FwdLayout(CPC).total;
    if (const int e = allow_smem<flash_fwd_bf16<CPC, CLUSTER>>(smem)) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n * ((Sq + BOX - 1) / BOX), B * H);
    cfg.blockDim = dim3(WS_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, flash_fwd_bf16<CPC, CLUSTER>, mq, mk, mv,
                                             static_cast<bf16*>(o), lse, H, Sq, Sk, D, n,
                                             scale * LOG2E);
    if (e != cudaSuccess) return (int)e;
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

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int H, int Sq, int Sk, int D, long long q_sb, long long q_ss, long long k_sb,
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

    load_tile_f32(sQ, ldt, qb + q0 * q_ss, q_ss, min(BQ32, Sq - q0), BQ32, D, Dp);
    for (int i = threadIdx.x; i < BQ32 * ldo; i += NTHREADS) sO[i] = 0.f;
    for (int i = threadIdx.x; i < BQ32; i += NTHREADS) { sM[i] = -1e30f; sL[i] = 0.f; }

    for (int k0 = 0; k0 < Sk; k0 += BK32) {
        const int nk = min(BK32, Sk - k0);
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

    const int nq = min(BQ32, Sq - q0);
    for (int idx = threadIdx.x; idx < nq * D; idx += NTHREADS) {
        const int r = idx / D, d = idx - r * D;
        o[(((long long)b * Sq + q0 + r) * H + h) * D + d] = sO[r * ldo + d] / sL[r];
    }
    for (int r = threadIdx.x; r < nq; r += NTHREADS)
        lse[(long long)bh * Sq + q0 + r] = sM[r] + logf(sL[r]);
}

int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int Sq, int Sk, int D, long long q_sb, long long q_ss, long long k_sb,
               long long k_ss, long long v_sb, long long v_ss, float scale, cudaStream_t st) {
    const size_t smem = LayoutF32(D).total;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ32 - 1) / BQ32, B * H);
    flash_fwd_f32<<<grid, NTHREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, Sq, Sk, D, q_sb, q_ss,
        k_sb, k_ss, v_sb, v_ss, scale);
    return (int)cudaGetLastError();
}

size_t smem_bytes(int D, int dtype) {
    if (dtype == 1) return D > MAX_D ? ~size_t(0) : FwdLayout(Split(D).cpc).total;
    return LayoutF32(D).total;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at head dim D (dtype 0 = f32, 1 = bf16).
long long medimgen_flash_attn_smem_bytes(int D, int dtype) { return (long long)smem_bytes(D, dtype); }

long long medimgen_flash_attn_smem_limit() { return (long long)MAX_SMEM; }

// q: element (b, s, h, d) at base + b*sb + s*ss + h*D + d for s < Sq; k, v
// the same for s < Sk. o: contiguous (B, Sq, H, D); lse: contiguous f32
// (B*H, Sq).
// vec != 0: every base pointer is 16-byte aligned and D and all strides are
// multiples of 8 elements. The bf16 kernel loads through TMA and needs it
// (the caller copies other inputs first). Returns the cudaError_t code.
int medimgen_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int H, int Sq, int Sk, int D, int dtype,
                            long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                            long long v_sb, long long v_ss, float scale, int vec,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (smem_bytes(D, dtype) > MAX_SMEM || D < 1 || Sq < 1 || Sk < 1)
        return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch_f32(q, k, v, o, lse, B, H, Sq, Sk, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                          scale, st);
    if (dtype != 1 || !vec) return (int)cudaErrorInvalidValue;
    const Split sp(D);
    // n > 1 only from D = 513, where cpc is 3
#define MEDIMGEN_ARGS \
    q, k, v, o, lse, B, H, Sq, Sk, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, sp.n, st
    if (sp.n > 1)
        return sp.cpc == 3 ? launch_bf16<3, true>(MEDIMGEN_ARGS) : (int)cudaErrorInvalidValue;
    switch (sp.cpc) {
        case 1: return launch_bf16<1, false>(MEDIMGEN_ARGS);
        case 2: return launch_bf16<2, false>(MEDIMGEN_ARGS);
        case 3: return launch_bf16<3, false>(MEDIMGEN_ARGS);
        case 4: return launch_bf16<4, false>(MEDIMGEN_ARGS);
        default: return (int)cudaErrorInvalidValue;
    }
#undef MEDIMGEN_ARGS
}

}  // extern "C"
