// Flash-attention backward for Hopper (sm_90a) at head dims up to 64, plain C
// interface for ctypes.
//
// Replaces, at small head dims, the TPU kernel `_bwd_fused_kernel` /
// `_flash_backward` in medical_image_generation_tpu/ops/pallas_attention.py
// (:187-358), as flash_attn_bwd.cu does at the wide ones, in the same
// deterministic two-pass form and with the same interface: from q, k, v, o,
// dO and the forward's f32 row logsumexp lse (B*H, Sq),
//
//   p = exp(scale q k^T - lse),  delta = rowsum(dO * o),
//   dv = p^T dO,  ds = scale p (dO v^T - delta),  dk = ds^T q,  dq = ds k;
//
// the dQ pass writes dq and delta, the dK/dV pass (after it on the stream)
// reads delta. ops/flash_attention.py sends bf16 inputs whose head dim, padded
// to 8, is at most 64 here (MAISI's heads of 32).
//
// Bounds on this card at MAISI's (1, 32768, 8, 32): the dQ pass's three Sq Sk
// D products (S, dP, dQ) are 1.67 ms at 989 TFLOP/s, the dK/dV pass's four
// (S^T, dP^T, dV, dK) 2.22 ms; each pass takes B*H*Sq*Sk = 8.6e9 exponentials,
// 2.2 ms at ~3.9e12/s. (chip_smoke.py's bound counts the 5 products the math
// needs, 2.78 ms for the two passes.) The bytes are ~0.02 ms.
//
// Why not flash_attn_bwd.cu: it splits the work of one tile between two
// warpgroups (S and P on one, dP and dS on the other, P and dS handed over
// through shared memory with mbarriers every tile) and D into 64-column
// chunks; at D = 32 the handoffs are most of the work and every product is
// half zero fill.
//
// Design (bf16 only; the fp32 path stays in flash_attn_bwd.cu). Tiles of 64
// keys or queries, DP = 32 or 64 columns a row (64-byte swizzle at 32, 128-byte
// at 64; TMA zero-fills past Sq, Sk and D); a CTA of NWG consumer warpgroups
// and one producer warp; each consumer warp releases a ring stage with one
// arrival. No split of D, no handoff between warpgroups, no cluster:
//   * dQ pass: warpgroup w owns 64 query rows and all of dQ (16 or 32 floats a
//     thread). For each 64-key K/V tile it forms S = Q K^T and dP = dO V^T
//     itself (m64n64k16, both operands K-major, from its resident Q and dO),
//     P = exp2(scale log2e s - lse log2e) (0 past Sk, on the last tile only)
//     and dS = scale P (dP - delta) in registers, and adds dS K (A from
//     registers, K read MN-major from the tile S read K-major). Tile j's dS K
//     runs on the tensor cores behind tile j+1's S and dP, while the
//     warpgroup computes tile j+1's exponentials. delta = rowsum(dO * o) comes
//     first, from 16-byte loads, each row summed by a quad in a fixed order.
//   * dK/dV pass: warpgroup w owns 64 keys and both accumulators (dK and dV,
//     2 x 16 or 2 x 32 floats a thread). For each 64-query Q/dO tile it forms
//     S^T = K Q^T and dP^T = V dO^T itself, P^T and dS^T in registers, and
//     adds P^T dO into dV and dS^T Q into dK (A from registers, dO and Q read
//     MN-major from the tiles the scores read K-major). The producer warp
//     also stages each tile's lse (log2 units, +inf past Sq) and delta (0 past
//     Sq) in the ring beside Q and dO.
//   * fixed summation orders and no atomics: dq, delta, dk and dv are the same
//     bits on every run. Rows past Sq or Sk are computed on zero fill and not
//     stored.
// NWG = 3 at DP = 32 (416 threads; 122 registers a thread in the dQ pass, 127
// in the dK/dV pass, under their cap of 128), 2 at DP = 64 (288 threads; 139
// and 160 under a cap of 168: the larger accumulators). Timed on the card at
// (1, 32768, 8, 32), dQ / dK/dV: NWG = 2 7.24 / 6.42 ms, 3 6.34 / 5.56, 4
// 16.2 / 10.3 (its cap of 102 spills). Shared memory at DP = 32: dQ pass Q and dO 24 KB, four K/V stages
// 32 KB; dK/dV pass K and V 24 KB, four Q/dO stages 32 KB.
//
// Tried and dropped: S and dP (S^T and dP^T) as separate commit groups, so
// that the exponentials run while dP is formed: dQ 6.35 -> 6.57 ms, dK/dV
// 5.56 -> 7.53 (its registers rose to the cap and spilled). The registers'
// cap is set by the SM sub-partition that holds the producer warp beside one
// warp of each consumer warpgroup: 16,384 / (32 (NWG + 1)), 128 at NWG = 3.
// A producer warpgroup that hands its registers over with setmaxnreg did not
// lift it: ptxas still compiled the consumers under the launch cap, and the
// first run stalled on the card.
//
// Not yet: the dK/dV pass's products behind the next tile's scores (its
// registers are the limit at NWG = 3), ping-pong of the warpgroups, a
// persistent grid, fusing the two passes.

#include "flash_narrow.cuh"

namespace {

constexpr int T = 64;       // keys (dQ pass) or queries (dK/dV pass) a streamed tile
constexpr int STAGES = 4;   // ring depth

template <int DP, int NWG>
struct NarrowBwdLayout {
    static constexpr unsigned BOX = 64 * 2 * DP;     // one warpgroup's 64 resident rows
    static constexpr unsigned TBOX = T * 2 * DP;     // one streamed tile of one tensor
    static constexpr unsigned res = 0;                // resident: NWG boxes of Q (K), then of dO (V)
    static constexpr unsigned ring = 2 * NWG * BOX;   // stage s: tiles 2s (K or Q), 2s + 1 (V or dO)
    static constexpr unsigned rows = ring + STAGES * 2 * TBOX;  // dK/dV: stage s's lse, delta
    static constexpr unsigned bars = rows + STAGES * 2 * T * 4; // full[], empty[], res
    static constexpr unsigned total = bars + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// dq and delta for NWG * 64 query rows of one (batch, head).
// o, dO, dq: contiguous (B, Sq, H, D), 16-byte aligned, D a multiple of 8.
template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_bwd_dq_narrow_bf16(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo, const bf16* __restrict__ o,
                         const bf16* __restrict__ dO, const float* __restrict__ lse,
                         float* __restrict__ delta, bf16* __restrict__ dq, int H, int Sq, int Sk,
                         int D, float scale, float scale_log2) {
    using L = NarrowBwdLayout<DP, NWG>;
    constexpr int KS = DP / 16;   // k16 steps of the scores
    constexpr int NS = T / 2;     // score floats a thread (64 x T)
    constexpr int NA = DP / 2;    // dQ floats a thread (64 x DP)
    constexpr int KK = T / 16;    // k16 steps of dS K
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* empty = full + STAGES;
    uint64_t* resbar = empty + STAGES;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.x * NWG * 64;
    const int ntiles = (Sk + T - 1) / T;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], NWG * 4);
        }
        mbar_init(resbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (threadIdx.x >= NWG * 128) {  // ---- producer warp: one thread feeds Q, dO and the K/V ring
        if (threadIdx.x == NWG * 128) {
            mbar_expect_tx(resbar, 2 * NWG * L::BOX);
#pragma unroll 1
            for (int w = 0; w < NWG; ++w) {
                tma_load_box(smem + L::res + w * L::BOX, &mq, 0, h, q0 + 64 * w, b, resbar);
                tma_load_box(smem + L::res + (NWG + w) * L::BOX, &mdo, 0, h, q0 + 64 * w, b,
                             resbar);
            }
#pragma unroll 1
            for (int j = 0; j < ntiles; ++j) {
                const int s = j % STAGES;
                if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
                unsigned char* sK = smem + L::ring + 2 * s * L::TBOX;
                mbar_expect_tx(&full[s], 2 * L::TBOX);
                tma_load_box(sK, &mk, 0, h, j * T, b, &full[s]);
                tma_load_box(sK + L::TBOX, &mv, 0, h, j * T, b, &full[s]);
            }
        }
        return;
    }

    // ---- consumer warpgroups: 64 query rows each, rows g and g + 8 of warp w's 16
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int w = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    const int row0 = q0 + 64 * wg;
    // this thread's rows: lse in log2 units, delta = rowsum(dO * o) over
    // interleaved 8-column groups by the row's quad, in a fixed order
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * w + g + 8 * r;
        lse2[r] = row < Sq ? lse[(long long)bh * Sq + row] * LOG2E : INFINITY;
        float acc = 0.f;
        if (row < Sq) {
            const long long off = (((long long)b * Sq + row) * H + h) * D;
            for (int c = 8 * tq; c < D; c += 32) {
                const uint4 ov = *reinterpret_cast<const uint4*>(o + off + c);
                const uint4 dv = *reinterpret_cast<const uint4*>(dO + off + c);
                const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
                const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
                    acc = fmaf(of.x, df.x, acc);
                    acc = fmaf(of.y, df.y, acc);
                }
            }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        dlt[r] = acc;
        if (tq == 0 && row < Sq) delta[(long long)bh * Sq + row] = acc;
    }

    const unsigned char* sQ = smem + L::res + wg * L::BOX;
    const unsigned char* sdO = smem + L::res + (NWG + wg) * L::BOX;
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    unsigned da[KK][4];  // the previous tile's dS, bf16 A fragments
    mbar_wait(resbar, 0);

#pragma unroll 1
    for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES, k0 = j * T;
        const unsigned char* sK = smem + L::ring + 2 * s * L::TBOX;
        mbar_wait(&full[s], (j / STAGES) & 1);

        float sc[NS], dp[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            wgmma_scores(sc, narrow_kmajor<DP>(sQ + 32 * kk), narrow_kmajor<DP>(sK + 32 * kk),
                         kk > 0);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            wgmma_scores(dp, narrow_kmajor<DP>(sdO + 32 * kk),
                         narrow_kmajor<DP>(sK + L::TBOX + 32 * kk), kk > 0);
        wgmma_commit();
        if (j > 0) {  // dQ += dS K of the previous tile, behind this tile's scores
            const unsigned char* sKp = smem + L::ring + 2 * ((j - 1) % STAGES) * L::TBOX;
#pragma unroll
            for (int kk = 0; kk < KK; ++kk)
                wgmma_m64k16_rs(acc, da[kk], narrow_mnmajor<DP>(sKp + kk * 16 * 2 * DP));
            wgmma_commit();
            wgmma_wait<1>();
        } else {
            wgmma_wait<0>();
        }
        fence_operand(sc);
        fence_operand(dp);

        // p = exp(scale s - lse) (0 past Sk), ds = scale p (dP - delta)
        const bool edge = k0 + T > Sk;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const int r = (i >> 1) & 1;
            float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
            if (edge && k0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= Sk) p = 0.f;
            dp[i] = scale * p * (dp[i] - dlt[r]);
        }
        unsigned dn[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) acc_to_a(dn[kk], dp, kk);

        if (j > 0) {  // the previous tile's dS K is done: its stage and da are free
            wgmma_wait<0>();
            fence_operand(da);
            fence_operand(acc);
            if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
        }
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) da[kk][e] = dn[kk][e];
    }

    // the last tile's dS K
    const unsigned char* sKl = smem + L::ring + 2 * ((ntiles - 1) % STAGES) * L::TBOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
        wgmma_m64k16_rs(acc, da[kk], narrow_mnmajor<DP>(sKl + kk * 16 * 2 * DP));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    const float one[2] = {1.f, 1.f};
    store_rows(dq, acc, one, b, h, H, Sq, D, row0, w, g, tq);
}

// dk, dv for NWG * 64 keys of one (batch, head), walking every 64-query Q/dO
// tile; reads the delta the dQ pass wrote.
template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_bwd_dkdv_narrow_bf16(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk,
                           int D, float scale, float scale_log2) {
    using L = NarrowBwdLayout<DP, NWG>;
    constexpr int KS = DP / 16;   // k16 steps of the scores
    constexpr int NS = T / 2;     // score floats a thread (64 keys x T queries)
    constexpr int NA = DP / 2;    // dK or dV floats a thread (64 x DP)
    constexpr int KK = T / 16;    // k16 steps of P^T dO and dS^T Q
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    float* rows = reinterpret_cast<float*>(smem + L::rows);  // stage s: lse2[T], delta[T]
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* empty = full + STAGES;
    uint64_t* resbar = empty + STAGES;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int k0 = blockIdx.x * NWG * 64;
    const int ntiles = (Sq + T - 1) / T;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 32);  // the producer warp's lanes (lane 0's with the bytes)
            mbar_init(&empty[s], NWG * 4);
        }
        mbar_init(resbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (threadIdx.x >= NWG * 128) {  // ---- producer warp: K and V once, the Q/dO/row ring
        const int lane = threadIdx.x % 32;
        if (lane == 0) {
            mbar_expect_tx(resbar, 2 * NWG * L::BOX);
#pragma unroll 1
            for (int w = 0; w < NWG; ++w) {
                tma_load_box(smem + L::res + w * L::BOX, &mk, 0, h, k0 + 64 * w, b, resbar);
                tma_load_box(smem + L::res + (NWG + w) * L::BOX, &mv, 0, h, k0 + 64 * w, b,
                             resbar);
            }
        }
        const float* lse_bh = lse + (long long)bh * Sq;
        const float* delta_bh = delta + (long long)bh * Sq;
        // each lane stages queries lane and lane + 32 of a tile, loaded a tile ahead
        float lv[2], dv_[2];
        auto fetch = [&](int j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int q = j * T + lane + 32 * e;
                lv[e] = q < Sq ? lse_bh[q] * LOG2E : INFINITY;
                dv_[e] = q < Sq ? delta_bh[q] : 0.f;
            }
        };
        fetch(0);
#pragma unroll 1
        for (int j = 0; j < ntiles; ++j) {
            const int s = j % STAGES;
            if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
            float* rs = rows + s * 2 * T;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                rs[lane + 32 * e] = lv[e];
                rs[T + lane + 32 * e] = dv_[e];
            }
            if (lane == 0) {
                unsigned char* sQ = smem + L::ring + 2 * s * L::TBOX;
                mbar_expect_tx(&full[s], 2 * L::TBOX);
                tma_load_box(sQ, &mq, 0, h, j * T, b, &full[s]);
                tma_load_box(sQ + L::TBOX, &mdo, 0, h, j * T, b, &full[s]);
            } else {
                mbar_arrive(&full[s]);
            }
            if (j + 1 < ntiles) fetch(j + 1);
        }
        return;
    }

    // ---- consumer warpgroups: 64 keys each, rows g and g + 8 of warp w's 16
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int w = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    const unsigned char* sK = smem + L::res + wg * L::BOX;
    const unsigned char* sV = smem + L::res + (NWG + wg) * L::BOX;
    float acc_k[NA], acc_v[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(resbar, 0);

#pragma unroll 1
    for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        const unsigned char* sQ = smem + L::ring + 2 * s * L::TBOX;
        const unsigned char* sdO = sQ + L::TBOX;
        const float* rs = rows + s * 2 * T;
        mbar_wait(&full[s], (j / STAGES) & 1);

        float sc[NS], dp[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            wgmma_scores(sc, narrow_kmajor<DP>(sK + 32 * kk), narrow_kmajor<DP>(sQ + 32 * kk),
                         kk > 0);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            wgmma_scores(dp, narrow_kmajor<DP>(sV + 32 * kk), narrow_kmajor<DP>(sdO + 32 * kk),
                         kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(sc);
        fence_operand(dp);

        // p^T = exp(scale s^T - lse), ds^T = scale p^T (dP^T - delta); this
        // thread's query columns 8i + 2tq + {0, 1}
#pragma unroll
        for (int i = 0; i < NS / 4; ++i) {
            const float2 lz = *reinterpret_cast<const float2*>(rs + 8 * i + 2 * tq);
            const float2 dz = *reinterpret_cast<const float2*>(rs + T + 8 * i + 2 * tq);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2(fmaf(sc[4 * i + e], scale_log2, (e & 1) ? -lz.y : -lz.x));
                dp[4 * i + e] = scale * p * (dp[4 * i + e] - ((e & 1) ? dz.y : dz.x));
                sc[4 * i + e] = p;
            }
        }
        unsigned pa[KK][4], da[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
            acc_to_a(pa[kk], sc, kk);
            acc_to_a(da[kk], dp, kk);
        }

        // dV += P^T dO, dK += dS^T Q (dO and Q read MN-major)
        fence_operand(acc_v);
        fence_operand(acc_k);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
            wgmma_m64k16_rs(acc_v, pa[kk], narrow_mnmajor<DP>(sdO + kk * 16 * 2 * DP));
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
            wgmma_m64k16_rs(acc_k, da[kk], narrow_mnmajor<DP>(sQ + kk * 16 * 2 * DP));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc_v);
        fence_operand(acc_k);
        if (lane == 0) mbar_arrive(&empty[s]);
    }

    const int row0 = k0 + 64 * wg;
    const float one[2] = {1.f, 1.f};
    store_rows(dv, acc_v, one, b, h, H, Sk, D, row0, w, g, tq);
    store_rows(dk, acc_k, one, b, h, H, Sk, D, row0, w, g, tq);
}

struct Args {
    const void *q, *k, *v, *o, *dO;
    const float* lse;
    float* delta;
    void *dq, *dk, *dv;
    int B, H, Sq, Sk, D;
    long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
    float scale;
    cudaStream_t st;
};

// Tensor maps of q, k, v and dO (contiguous BSHD), boxes of `qrows` rows of q
// and dO and `krows` of k and v.
template <int DP>
int make_maps(const Args& a, CUtensorMap* m, int qrows, int krows) {
    const long long o_ss = (long long)a.H * a.D, o_sb = o_ss * a.Sq;
    int err = make_map_narrow<DP>(&m[0], a.q, a.B, a.H, a.Sq, a.D, a.q_sb, a.q_ss, qrows);
    if (!err) err = make_map_narrow<DP>(&m[1], a.k, a.B, a.H, a.Sk, a.D, a.k_sb, a.k_ss, krows);
    if (!err) err = make_map_narrow<DP>(&m[2], a.v, a.B, a.H, a.Sk, a.D, a.v_sb, a.v_ss, krows);
    if (!err) err = make_map_narrow<DP>(&m[3], a.dO, a.B, a.H, a.Sq, a.D, o_sb, o_ss, qrows);
    return err;
}

template <int DP, int NWG>
int launch_dq(const Args& a) {
    CUtensorMap m[4];
    if (const int e = make_maps<DP>(a, m, 64, T)) return e;
    constexpr unsigned smem = NarrowBwdLayout<DP, NWG>::total;
    if (const int e = allow_smem<flash_bwd_dq_narrow_bf16<DP, NWG>>(smem)) return e;
    const dim3 grid((a.Sq + NWG * 64 - 1) / (NWG * 64), a.B * a.H);
    flash_bwd_dq_narrow_bf16<DP, NWG><<<grid, NWG * 128 + 32, smem, a.st>>>(
        m[0], m[1], m[2], m[3], static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dO),
        a.lse, a.delta, static_cast<bf16*>(a.dq), a.H, a.Sq, a.Sk, a.D, a.scale,
        a.scale * LOG2E);
    return (int)cudaGetLastError();
}

template <int DP, int NWG>
int launch_dkdv(const Args& a) {
    CUtensorMap m[4];
    if (const int e = make_maps<DP>(a, m, T, 64)) return e;
    constexpr unsigned smem = NarrowBwdLayout<DP, NWG>::total;
    if (const int e = allow_smem<flash_bwd_dkdv_narrow_bf16<DP, NWG>>(smem)) return e;
    const dim3 grid((a.Sk + NWG * 64 - 1) / (NWG * 64), a.B * a.H);
    flash_bwd_dkdv_narrow_bf16<DP, NWG><<<grid, NWG * 128 + 32, smem, a.st>>>(
        m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.H, a.Sq, a.Sk, a.D, a.scale, a.scale * LOG2E);
    return (int)cudaGetLastError();
}

int run(const Args& a, int dtype, int vec, bool dq_pass) {
    if (dtype != 1 || !vec || a.D < 1 || a.D > NARROW_MAX_D || a.Sq < 1 || a.Sk < 1)
        return (int)cudaErrorInvalidValue;
    if (dq_pass) return a.D <= 32 ? launch_dq<32, 3>(a) : launch_dq<64, 2>(a);
    return a.D <= 32 ? launch_dkdv<32, 3>(a) : launch_dkdv<64, 2>(a);
}

}  // namespace

extern "C" {

// The arguments of medimgen_flash_attn_bwd_dq / _dkdv (flash_attn_bwd.cu): q
// with element (b, s, h, d) at base + b*sb + s*ss + h*D + d for s < Sq, k and
// v the same for s < Sk; o, dO and dq contiguous (B, Sq, H, D), dk and dv
// contiguous (B, Sk, H, D); lse, delta contiguous f32 (B*H, Sq). Takes bf16
// (dtype 1) with vec != 0 (16-byte aligned bases, D and strides multiples of
// 8) and D <= 64 only. The dq pass writes dq and delta; the dk/dv pass reads
// delta and must run after it on the same stream. Each returns the
// cudaError_t code.
int medimgen_flash_narrow_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dO, const float* lse, float* delta, void* dq, int B,
                                 int H, int Sq, int Sk, int D, int dtype, long long q_sb,
                                 long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                                 long long v_ss, float scale, int vec, void* stream) {
    const Args a{q, k, v, o, dO, lse, delta, dq, nullptr, nullptr, B, H, Sq, Sk, D, q_sb,
                 q_ss, k_sb, k_ss, v_sb, v_ss, scale, static_cast<cudaStream_t>(stream)};
    return run(a, dtype, vec, true);
}

int medimgen_flash_narrow_bwd_dkdv(const void* q, const void* k, const void* v, const void* dO,
                                   const float* lse, const float* delta, void* dk, void* dv,
                                   int B, int H, int Sq, int Sk, int D, int dtype,
                                   long long q_sb, long long q_ss, long long k_sb,
                                   long long k_ss, long long v_sb, long long v_ss, float scale,
                                   int vec, void* stream) {
    const Args a{q, k, v, nullptr, dO, lse, const_cast<float*>(delta), nullptr, dk, dv, B, H,
                 Sq, Sk, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                 static_cast<cudaStream_t>(stream)};
    return run(a, dtype, vec, false);
}

}  // extern "C"
