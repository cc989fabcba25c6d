// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_bwd_fused_kernel` / `_flash_backward` in
// medical_image_generation_tpu/ops/pallas_attention.py (:187-358). From q, k, v,
// o, dO and the f32 row logsumexp `lse` (B*H, Sq) that the forward writes,
// with queries (and o, dO, dq) of Sq rows and keys and values (and dk, dv) of
// Sk rows (the TPU kernel takes one S for all; Sk is a cross-attention
// context's own length here):
//
//   p = exp(scale q k^T - lse),  delta = rowsum(dO * o),
//   dv = p^T dO,  ds = scale p (dO v^T - delta),  dk = ds^T q,  dq = ds k.
//
// The TPU kernel walks K blocks and accumulates dq by a read-modify-write in
// HBM, which is safe only because the TPU grid runs in order (:199-202). CUDA
// blocks run in any order, so this is the deterministic two-pass form, with
// no atomics:
//   * dq kernel: a block owns 64 query rows and walks the K/V tiles. It
//     also computes delta for its rows and writes it to (B*H, Sq) f32.
//   * dk/dv kernel (launched after it on the same stream): a cluster owns 64
//     keys and walks the Q/dO tiles, reading lse and delta.
// Both recompute q k^T and dO v^T, so the pair does 7 Sq Sk D matmuls where
// the fused form does 5; fusing the two needs atomics or a cluster
// reduction for dq.
//
// Bound on this card: operations, counted as the 5 Sq Sk D matmuls the math
// needs, 10*B*H*Sq*Sk*D FLOP at 989 TFLOP/s (bf16 tensor cores), against
// the bytes (q, k, v, o, dO read once, dq, dk, dv written once) at 3.35
// TB/s. The bytes bound the small (512-token, D = 768) sites and a short
// context (Sk = 77): there the dK/dV grid is a few key blocks, each walking
// every query, and the dQ kernel's one key tile is mostly zero fill.
//
// dq kernel (bf16): the dQ accumulator of 64 rows is 64 x D f32 (32,768
// registers at D = 512), so the head dim is split as in the forward: each
// CTA has two consumer warpgroups, and warpgroup w of CTA rank r owns the
// 64-column chunks [(2r + w)*CPC, (2r + w + 1)*CPC) of dQ (CPC <= 4; n = 1
// up to D = 512, a 2-CTA cluster with CPC = 3 above):
//   * the two score matrices are split between the warpgroups, not their
//     columns: warpgroup 0 forms S = Q K^T, warpgroup 1 dP = dO V^T, each
//     over the CTA's head-dim columns (wgmma m64nKTk16, both operands K-major
//     in shared memory). In a cluster the n partials of each are summed in
//     rank order through DSMEM, so both CTAs hold the same bits. No partial
//     is exchanged inside a CTA.
//   * warpgroup 0 turns S into P = exp2(scale log2e s - lse log2e) (0 past
//     Sk) and hands it to warpgroup 1 through shared memory; warpgroup 1 forms
//     dS = scale P (dP - delta), packs it into bf16 wgmma A fragments and
//     hands those back (mbarrier handoffs, double-buffered). Both then take
//     dQ += dS K on their own chunks (wgmma m64nNk16, N = 64*CPC, A from
//     registers), with K read MN-major from the tile S read K-major.
//   * delta = rowsum(dO * o) comes from 16-byte loads of o and dO at the
//     start, each row summed by one quad in a fixed order.
//   * one producer warp (one thread) loads Q and dO once and the K/V tiles
//     through TMA into a 2-stage ring (zero fill outside Sq, Sk and D). No
//     setmaxnreg: the 288 threads get ptxas's 224 registers each, which
//     holds the 128 accumulator floats with no spill (setmaxnreg needs whole
//     producer warpgroups, whose 168-register cap spills).
//   * keys a tile: 32 where two K/V stages fit beside the resident Q and dO
//     (128 KB at D = 512), else 16 (D = 512, and the cluster sites).
//   * fixed summation orders and no atomics: dq and delta are the same bits
//     on every run. Keys past Sk get p = ds = 0 (a context shorter than one
//     key tile is one partial tile); rows past Sq are not stored.
// Shared memory at D = 512: Q and dO 128 KB, two 16-key K/V stages 64 KB,
// P and dS slots 12 KB.
//
// dk/dv kernel (bf16): the dK and dV accumulators of 64 keys are 2 x 64 x D
// f32 (65,536 registers at D = 512, the whole register file), so the head
// dim is split across a cluster of n CTAs: CTA rank r owns the 64-column
// chunks [r*CPC, (r+1)*CPC) (CPC <= 4; n = 1 up to D = 256, 2 up to 512, 3
// up to 768), and its two warpgroups take one accumulator each (at
// most 128 floats a thread).
// Its bound is the 4 Sq Sk D products it forms (S^T, dP^T, dV, dK): at
// (2, 4096, 1, 512) 0.139 ms at 989 TFLOP/s.
//   * warpgroup 0 forms the partial S^T = K_r Q_r^T (64 keys x 32 queries,
//     wgmma m64n32k16, both operands K-major in shared memory), warpgroup 1
//     the partial dP^T = V_r dO_r^T. The cluster's n partials of each are
//     summed in rank order, so every CTA holds the same bits. A pair (n = 2)
//     pushes its partial into the peer's slot (st.async, each 16 bytes
//     counted on the peer's mbarrier as transaction bytes), so a CTA waits
//     only for data the peer sent on its own, never for a reply. A cluster of
//     3 publishes its partial in its own slot and reads the others' (mbarrier
//     arrivals at cluster scope, then ld.shared::cluster).
//   * warpgroup 0 turns S^T into P^T = exp2(scale log2e s - lse log2e) in
//     registers and passes it to warpgroup 1 through shared memory (mbarrier
//     handoff, double-buffered); warpgroup 1 forms dS^T = scale P^T (dP^T -
//     delta). Both feed their tile straight from registers into the A operand
//     of dV += P^T dO_r and dK += dS^T Q_r (wgmma m64nNk16, N = 64*CPC), with
//     dO and Q read MN-major from the same shared-memory tiles the scores read
//     K-major: nothing is transposed.
//   * a software pipeline hides the exchange: a warpgroup issues tile j+1's
//     scores before it waits for tile j's partials, and issues tile j's
//     product behind them, so the tensor cores hold tile j+1's scores and
//     tile j-1's product while tile j's partials travel and its exponentials
//     run. Commit groups complete in order: wgmma wait<1> leaves only the
//     newest pending. Tile j+1's lse and delta are loaded with its scores
//     and first read a tile later.
//   * 256 threads, no producer warp: ptxas caps a thread's registers by the
//     SM sub-partition holding the most warps, 16,384 / (32 x 3) = 168 with a
//     ninth warp, and compiles under that cap whatever setmaxnreg later
//     grants; with two warps a sub-partition the cap is 255, and the pipeline
//     holds 254 at CPC = 4 with no spill. Thread 0 issues the TMA loads of
//     K_r, V_r and the first Q_r / dO_r tiles (32 queries, a 3-stage ring,
//     128-byte swizzle, zero fill outside Sq, Sk and D); thread 128 refills
//     a stage once both warpgroups have released it (warpgroup 1 releases
//     last: it waits for warpgroup 0's P^T).
//   * when the grid would not fill the card once (the 512-token sites, a
//     short context's one or two key blocks), a
//     cluster also splits the queries in two halves: twice the CTAs, each
//     walking half the Q/dO tiles; at the end the half-1 CTA leaves its
//     accumulators in shared memory and the half-0 CTA adds them (DSMEM, in
//     that order) and stores dk and dv.
//   * fixed summation orders and no atomics: dk and dv are the same bits on
//     every run, and the same bits as the unpipelined schedule before it
//     (the same sums in the same order). Queries past Sq get p = ds = 0; keys
//     past Sk are not stored (their rows of the accumulators hold the
//     products of zero-filled K and V, and touch no other row).
// Shared memory at D = 512: K and V 64 KB, three Q/dO stages 96 KB, partial
// and P slots 48 KB.
// On an H100 (80GB HBM3, 700 W; CUDA events, 10 launches) at (2, 4096, 1,
// 512) a tile took ~9,000 cycles in the unpipelined schedule (1.33 ms): with
// no exchange 0.86 ms, no lse/delta loads 1.08, no P handoff 1.25, none of
// the three 0.57. This design takes 0.44 ms (3.2x its bound), (48, 1024, 1,
// 512) 0.72 from 2.07; the issue of a tile's 16 score wgmmas, which waits
// for the tensor cores, is its largest part (~1,450 of ~3,500 cycles before
// the last fix). ptxas reports (C7514) when it serializes wgmmas because it
// cannot prove a group retired: the wait after the loop sat in a branch,
// and with it this design took 0.51 ms.
// Tried on the card and dropped (ms at (2, 4096, 1, 512)): the pipeline with
// a producer warp (288 threads, capped at 168 registers: 588 bytes of
// spills) 1.51, with the old producer warpgroup and setmaxnreg 1.78; lse and
// delta converted as soon as loaded (a tile then waited ~1,300 cycles for
// the loads) 0.88; a pair that publishes and reads its partials as a cluster of
// 3 does 0.74; a 4-stage ring that single-buffers the partials behind a
// "read" signal back 1.04 (then 0.88 with 3 stages); query tiles rotated
// per key block to spread the L2 reads, and an L2 prefetch of the tile after
// the one being loaded, within +-3%.
//
// f32 (used to check the port against the CPU in fp32): the same two-pass
// tiling with scalar f32 FMAs and shared-memory accumulators.
//
// Not yet: fusing the two passes, a persistent grid (the 2D site's 1,536 CTAs
// of 32 tiles each run 12 waves), pushed partials for clusters of 3 (their
// double-buffered slots would need 64 KB beside the ring), 64-query tiles
// (stages of 64 KB), TMA multicast (the CTAs of a cluster read different
// columns of Q and dO, so nothing is shared to multicast).

#include "flash_common.cuh"

namespace {

// ----------------------------------------------------------------- bf16 path

constexpr int DQ_STAGES = 2;      // K/V ring depth of the dq kernel
constexpr int DQ_THREADS = 288;   // two consumer warpgroups + one producer warp

// Shared memory of the dq kernel for cpc chunks a warpgroup and kt keys a
// tile: Q and dO resident (2*cpc boxes each), DQ_STAGES K/V stages, and per
// buffer (two, alternating by tile) the f32 P tile, in a cluster also the
// partial S and dP tiles, and the bf16 dS fragments.
struct DqLayout {
    unsigned nf, slot_bytes, buf_bytes, q, kv, slots, bars, total;
    __host__ __device__ constexpr DqLayout(int cpc, int kt, bool cluster)
        : nf(cluster ? 3 : 1), slot_bytes(kt * 256), buf_bytes(nf * slot_bytes + kt * 128),
          q(0),                                           // Q at +0, dO at +2*cpc boxes
          kv(4 * cpc * BOX_BYTES),                        // stage s: K at +0, V at +2*cpc boxes
          slots(kv + DQ_STAGES * 4 * cpc * kt * 128),     // [buffer][P, S part, dP part, dS]
          bars(slots + 2 * buf_bytes),
          total(bars + 13 * 8 + 1024) {}                  // + alignment slack
};

// Keys a tile: 32 where two stages of 32 keys fit beside the resident Q and
// dO, else 16 (D = 512, and the cluster sites, whose partial slots take room).
constexpr int dq_keys(int cpc, bool cluster) {
    return DqLayout(cpc, 32, cluster).total <= MAX_SMEM ? 32 : 16;
}

// dq for 64 query rows of one (batch, head) and head-dim chunks
// [rank*2*CPC, (rank+1)*2*CPC); also writes delta for those rows. One CTA of
// an n-CTA cluster (CLUSTER: n > 1). Warpgroup 0 forms S = Q K^T and P,
// warpgroup 1 forms dP = dO V^T and dS (from warpgroup 0's P); both then
// take dQ += dS K on their own CPC chunks. Warp 8 issues the TMA loads.
// o, dO, dq: contiguous (B, Sq, H, D), 16-byte aligned, D a multiple of 8.
template <int CPC, int KT, bool CLUSTER>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                  const bf16* __restrict__ o, const bf16* __restrict__ dO,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  bf16* __restrict__ dq, int H, int Sq, int Sk, int D, int n, float scale,
                  float scale_log2) {
    constexpr int NACC = CPC * 32;       // dq accumulator floats a thread (64 x 64*CPC)
    constexpr int NS = KT / 2;           // score floats a thread (64 x KT)
    constexpr int KK = KT / 16;          // k16 steps of dQ += dS K a tile
    constexpr unsigned KBOX = KT * 128;  // one 64-column box of KT keys
    constexpr DqLayout L(CPC, KT, CLUSTER);
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);  // [stage]
    uint64_t* empty = full + DQ_STAGES;                               // [stage]
    uint64_t* qbar = empty + DQ_STAGES;
    uint64_t* ready = qbar + 1;        // [buffer][warpgroup]: the cluster's partials
    uint64_t* p_ready = ready + 4;     // [buffer]: warpgroup 0's P is in its slot
    uint64_t* ds_ready = p_ready + 2;  // [buffer]: warpgroup 1's dS is in its slot

    const unsigned rank = CLUSTER ? cluster_ctarank() : 0;
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int q0 = (blockIdx.x / n) * BOX;
    const int col0 = rank * 2 * CPC * BOX;  // this CTA's first head-dim column
    const int ntiles = (Sk + KT - 1) / KT;

    if (threadIdx.x == 0) {
        for (int s = 0; s < DQ_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        mbar_init(qbar, 1);
        for (int s = 0; s < 2; ++s) {
            mbar_init(&ready[2 * s], n);
            mbar_init(&ready[2 * s + 1], n);
            mbar_init(&p_ready[s], 128);
            mbar_init(&ds_ready[s], 128);
        }
        mbar_init_fence();
    }
    __syncthreads();
    if (CLUSTER) cluster_sync();  // every CTA's barriers exist before any remote arrive

    if (threadIdx.x >= 256) {  // ---- producer warp: one thread feeds Q, dO and the K/V ring
        if (threadIdx.x == 256) {
            mbar_expect_tx(qbar, 4 * CPC * BOX_BYTES);
#pragma unroll 1
            for (int c = 0; c < 2 * CPC; ++c) {
                tma_load_box(smem + L.q + c * BOX_BYTES, &mq, col0 + c * BOX, h, q0, b, qbar);
                tma_load_box(smem + L.q + (2 * CPC + c) * BOX_BYTES, &mdo, col0 + c * BOX, h, q0,
                             b, qbar);
            }
#pragma unroll 1
            for (int j = 0; j < ntiles; ++j) {
                const int s = j % DQ_STAGES;
                if (j >= DQ_STAGES) mbar_wait(&empty[s], ((j / DQ_STAGES) - 1) & 1);
                unsigned char* sK = smem + L.kv + s * 4 * CPC * KBOX;
                mbar_expect_tx(&full[s], 4 * CPC * KBOX);
#pragma unroll 1
                for (int c = 0; c < 2 * CPC; ++c) {
                    tma_load_box(sK + c * KBOX, &mk, col0 + c * BOX, h, j * KT, b, &full[s]);
                    tma_load_box(sK + (2 * CPC + c) * KBOX, &mv, col0 + c * BOX, h, j * KT, b,
                                 &full[s]);
                }
            }
        }
        if (CLUSTER) cluster_sync();  // matches the consumers' final cluster barrier
        return;
    }

    // ---- consumer warpgroups: wg 0 -> S, P; wg 1 -> dP, dS; both -> dQ
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int w = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    // this thread's two query rows q0 + 16w + g + 8r: lse in log2 units (wg 0)
    // or delta = rowsum(dO * o) (wg 1), each row's quad over interleaved
    // 8-column groups of the whole head dim, summed in a fixed order
    float rowv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + 16 * w + g + 8 * r;
        if (wg == 0) {
            rowv[r] = row < Sq ? lse[(long long)bh * Sq + row] * LOG2E : INFINITY;
            continue;
        }
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
        rowv[r] = acc;
        if (rank == 0 && tq == 0 && row < Sq) delta[(long long)bh * Sq + row] = acc;
    }

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    const unsigned char* sA = smem + L.q + wg * 2 * CPC * BOX_BYTES;  // wg 0: Q, wg 1: dO
    mbar_wait(qbar, 0);

    for (int j = 0; j < ntiles; ++j) {
        const int s = j % DQ_STAGES, buf = j & 1, k0 = j * KT;
        const unsigned char* sK = smem + L.kv + s * 4 * CPC * KBOX;
        const unsigned char* sB = sK + wg * 2 * CPC * KBOX;  // wg 0: K, wg 1: V
        unsigned char* bslot = smem + L.slots + buf * L.buf_bytes;
        float4* pslot = reinterpret_cast<float4*>(bslot);
        uint4* dsslot = reinterpret_cast<uint4*>(bslot + L.nf * L.slot_bytes);
        mbar_wait(&full[s], (j / DQ_STAGES) & 1);

        // S (wg 0) or dP (wg 1) over this CTA's head-dim columns
        float sc[NS];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 2 * CPC; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_scores(sc, kmajor_desc(sA + c * BOX_BYTES + kk * 32),
                             kmajor_desc(sB + c * KBOX + kk * 32), c + kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(sc);

        if (CLUSTER) {  // sum the cluster's n partials of this matrix, in rank order
            float4* mine = reinterpret_cast<float4*>(bslot + (1 + wg) * L.slot_bytes);
            slot_store(mine, sc, t);
            slot_publish(&ready[2 * buf + wg], wg, t, n);
            slot_wait(&ready[2 * buf + wg], (j >> 1) & 1, wg, t);
            for (int r = 0; r < n; ++r) slot_add(sc, mine, t, r, true, r == 0);
        }

        unsigned a[KK][4];
        if (wg == 0) {  // p = exp(scale s - lse), 0 past Sk; hand it over, take dS back
#pragma unroll
            for (int i = 0; i < NS; ++i) {
                const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
                sc[i] = key < Sk ? exp2f(fmaf(sc[i], scale_log2, -rowv[(i >> 1) & 1])) : 0.f;
            }
            slot_store(pslot, sc, t);
            mbar_arrive(&p_ready[buf]);
            mbar_wait(&ds_ready[buf], (j >> 1) & 1);
#pragma unroll
            for (int kk = 0; kk < KK; ++kk) {
                const uint4 v = dsslot[kk * 128 + t];
                a[kk][0] = v.x; a[kk][1] = v.y; a[kk][2] = v.z; a[kk][3] = v.w;
            }
        } else {  // ds = scale p (dP - delta) as bf16 A fragments, handed to wg 0
            mbar_wait(&p_ready[buf], (j >> 1) & 1);
#pragma unroll
            for (int i = 0; i < NS / 4; ++i) {
                const float4 p = pslot[i * 128 + t];
                sc[4 * i] = scale * p.x * (sc[4 * i] - rowv[0]);
                sc[4 * i + 1] = scale * p.y * (sc[4 * i + 1] - rowv[0]);
                sc[4 * i + 2] = scale * p.z * (sc[4 * i + 2] - rowv[1]);
                sc[4 * i + 3] = scale * p.w * (sc[4 * i + 3] - rowv[1]);
            }
#pragma unroll
            for (int kk = 0; kk < KK; ++kk) {
                acc_to_a(a[kk], sc, kk);
                dsslot[kk * 128 + t] = make_uint4(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
            }
            mbar_arrive(&ds_ready[buf]);
        }

        // dQ += dS K on this warpgroup's chunks (K read MN-major: no transpose)
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
            wgmma_m64k16_rs(acc, a[kk], mnmajor_desc(sK + wg * CPC * KBOX + kk * 16 * 128, KBOX));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
        mbar_arrive(&empty[s]);
    }

    const int wcol0 = col0 + wg * CPC * BOX;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + 16 * w + g + 8 * r;
        if (row >= Sq) continue;
        bf16* orow = dq + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
        for (int i = 0; i < NACC / 4; ++i) {
            const int c = wcol0 + 8 * i + 2 * tq;
            if (c < D)
                *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                    __floats2bfloat162_rn(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
        }
    }
    if (CLUSTER) cluster_sync();  // no CTA leaves while a peer may read its slots
}

constexpr int DKV_STAGES = 3;     // Q/dO ring depth
constexpr int DKV_THREADS = 256;  // two warpgroups and no producer warp: a 255-register cap

// Head-dim split of one key block: NC 64-column chunks over n CTAs, cpc each
// (both warpgroups of a CTA work on the same cpc chunks).
struct DkvSplit {
    int n, cpc;
    explicit DkvSplit(int D) {
        const int nc = (D + BOX - 1) / BOX;
        n = (nc + 3) / 4;
        cpc = (nc + n - 1) / n;
    }
};

struct DkvLayout {
    unsigned kv, qdo, slots, bars, total;
    __host__ __device__ explicit DkvLayout(int cpc) {
        kv = 0;                                              // K at +0, V at +cpc boxes
        qdo = kv + 2 * cpc * BOX_BYTES;                      // stage s: Q at +0, dO at +cpc tiles
        slots = qdo + DKV_STAGES * 2 * cpc * TBOX_BYTES;     // [2 buffers][S^T, dP^T, P]
        bars = slots + 6 * SLOT_F4 * 16;
        total = bars + (2 * DKV_STAGES + 7) * 8 + 1024;     // + alignment slack
    }
};

// dk, dv for 64 keys of one (batch, head) and head-dim chunks
// [rank*CPC, (rank+1)*CPC), walking every 32-query Q/dO tile; reads the delta
// the dq kernel wrote. One CTA of an n-CTA cluster. Warpgroup 0 forms
// S^T = K Q^T, P^T and dV += P^T dO; warpgroup 1 forms dP^T = V dO^T, dS^T
// (from warpgroup 0's P^T) and dK += dS^T Q. Thread 0 issues the first TMA
// loads, thread 128 the ring's refills.
template <int CPC>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq, int Sk, int D,
                    int n, int halves, float scale, float scale_log2) {
    constexpr int NACC = CPC * 32;  // dv or dk accumulator floats a thread (64 x 64*CPC)
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    const DkvLayout L(CPC);
    float4* slots = reinterpret_cast<float4*>(smem + L.slots);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);  // [stage]
    uint64_t* empty = full + DKV_STAGES;                              // [stage]
    uint64_t* ready = empty + DKV_STAGES;  // [buffer][warpgroup]: the cluster's partials
    uint64_t* p_ready = ready + 4;         // [buffer]: warpgroup 0's P^T is in its slot
    uint64_t* p_free = p_ready + 2;        // [buffer]: warpgroup 1 has read it
    uint64_t* kvbar = p_free + 2;

    // cluster rank = half * n + r: column group r, query half `half`
    const unsigned rank = cluster_ctarank();
    const int r0 = rank - rank % n, half = rank / n;  // r0: rank of this half's column group 0
    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int k0 = (blockIdx.x / (n * halves)) * BOX;
    const int col0 = (rank % n) * CPC * BOX;
    const int per = ((Sq + TILE - 1) / TILE + halves - 1) / halves;  // query tiles a half
    const int jb = half * per, ntiles = max(0, min(per, (Sq + TILE - 1) / TILE - jb));
    const bool clustered = n * halves > 1;
    // stage s of the ring: Q at +0, dO at +CPC tiles
    auto stage = [&](int j) { return smem + L.qdo + (j % DKV_STAGES) * 2 * CPC * TBOX_BYTES; };
    auto load_tile = [&](int j) {  // one thread: tile j's Q and dO into its stage
        const int s = j % DKV_STAGES, q0 = (jb + j) * TILE;
        unsigned char* sQ = stage(j);
        mbar_expect_tx(&full[s], 2 * CPC * TBOX_BYTES);
#pragma unroll 1
        for (int c = 0; c < CPC; ++c) {
            tma_load_box(sQ + c * TBOX_BYTES, &mq, col0 + c * BOX, h, q0, b, &full[s]);
            tma_load_box(sQ + (CPC + c) * TBOX_BYTES, &mdo, col0 + c * BOX, h, q0, b, &full[s]);
        }
    };

    if (threadIdx.x == 0) {
        for (int s = 0; s < DKV_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        for (int s = 0; s < 2; ++s) {
            mbar_init(&ready[2 * s], n == 2 ? 1 : n);  // pairs: this CTA's expect-tx
            mbar_init(&ready[2 * s + 1], n == 2 ? 1 : n);
            mbar_init(&p_ready[s], 128);
            mbar_init(&p_free[s], 128);
        }
        mbar_init(kvbar, 1);
        mbar_init_fence();
    }
    __syncthreads();
    if (clustered) cluster_sync();  // every CTA's barriers exist before any remote arrive
    if (threadIdx.x == 0) {  // K and V of this CTA's columns, then the ring's first tiles
        mbar_expect_tx(kvbar, 2 * CPC * BOX_BYTES);
#pragma unroll 1
        for (int c = 0; c < CPC; ++c) {
            tma_load_box(smem + L.kv + c * BOX_BYTES, &mk, col0 + c * BOX, h, k0, b, kvbar);
            tma_load_box(smem + L.kv + (CPC + c) * BOX_BYTES, &mv, col0 + c * BOX, h, k0, b,
                         kvbar);
        }
#pragma unroll 1
        for (int j = 0; j < min(ntiles, DKV_STAGES); ++j) load_tile(j);
    }
    __syncwarp();

    // ---- warpgroups: wg 0 -> dV, wg 1 -> dK
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int w = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    // wg 0: S^T = K Q^T, then dV += P^T dO; wg 1: dP^T = V dO^T, then dK += dS^T Q.
    // A warpgroup's score operand (K-major) is its stage's tile +wg, its
    // product operand (MN-major) the tile +(1 - wg).
    const unsigned char* sA = smem + L.kv + wg * CPC * BOX_BYTES;
    // issue tile j's partial S^T (wg 0) or dP^T (wg 1) over this CTA's head-dim columns
    auto issue_scores = [&](int j, float (&sc)[16]) {
        const unsigned char* sB = stage(j) + wg * CPC * TBOX_BYTES;
        mbar_wait(&full[j % DKV_STAGES], (j / DKV_STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < CPC; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_m64n32k16_ss(sc, kmajor_desc(sA + c * BOX_BYTES + kk * 32),
                                   kmajor_desc(sB + c * TBOX_BYTES + kk * 32), c + kk > 0);
        wgmma_commit();
    };

    const float* row_bh = (wg == 0 ? lse : delta) + (long long)bh * Sq;
    const float past = wg == 0 ? INFINITY : 0.f;  // past Sq: p = 0, delta 0
    // this thread's 8 query columns of tile j, 8i + 2tq + e: lse or delta as
    // stored, loaded a tile ahead; nothing reads them before their tile, so
    // the loads' latency passes behind the tile before.
    auto load_rows = [&](int j, float (&rv)[8]) {
        const int i0 = (jb + j) * TILE;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int q = i0 + 8 * i + 2 * tq + e;
                rv[2 * i + e] = q < Sq ? row_bh[q] : past;
            }
    };
    // lse in log2 units for warpgroup 0
    auto to_log2 = [&](float (&rv)[8]) {
        if (wg == 0)
#pragma unroll
            for (int i = 0; i < 8; ++i) rv[i] *= LOG2E;
    };

    // sc, rv: tile j's scores and rows; sn, rn: tile j+1's, in flight
    float acc[NACC], sc[16], sn[16], rv[8], rn[8];
    unsigned a[2][4];  // tile j's P^T or dS^T as bf16 A fragments
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    mbar_wait(kvbar, 0);
    if (ntiles > 0) {
        load_rows(0, rv);
        issue_scores(0, sc);
        wgmma_wait<0>();
        fence_operand(sc);
        to_log2(rv);
    }

    // Per tile j the tensor cores run tile j+1's scores and tile j-1's product
    // while tile j's partials cross the cluster and the warpgroup forms P^T or
    // dS^T. Commit groups complete in order: wait<1> leaves only the newest
    // pending.
#pragma unroll 1
    for (int j = 0; j < ntiles; ++j) {
        const int buf = j & 1;
        const bool more = j + 1 < ntiles;
        // a pair's slot receives the peer's partial; a larger cluster's holds this CTA's
        float4* slot = slots + (3 * buf + wg) * SLOT_F4;
        uint64_t* got = &ready[2 * buf + wg];
        if (n == 2) {  // push this CTA's partial of tile j into the peer's slot
            if (t == 0) mbar_expect_tx(got, SLOT_F4 * 16);  // and expect the peer's
#pragma unroll
            for (int i = 0; i < 4; ++i)
                st_async_f4(&slot[i * 128 + t],
                            make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2], sc[4 * i + 3]),
                            got, rank ^ 1);
        } else if (n > 2) {  // publish it in this CTA's slot
            slot_store(slot, sc, t);
            slot_publish(got, wg, t, n, r0);
        }
        if (more) {
            issue_scores(j + 1, sn);
            load_rows(j + 1, rn);
        }
        if (j > 0) {  // tile j-1's product is done: its stage and the fragments are free
            if (more) wgmma_wait<1>();
            else wgmma_wait<0>();
            fence_operand(acc);
            fence_operand(a);
            mbar_arrive(&empty[(j - 1) % DKV_STAGES]);
            // refill it once both warpgroups released it (warpgroup 1 releases last)
            if (threadIdx.x == 128 && j - 1 + DKV_STAGES < ntiles) {
                mbar_wait(&empty[(j - 1) % DKV_STAGES], ((j - 1) / DKV_STAGES) & 1);
                load_tile(j - 1 + DKV_STAGES);
            }
            __syncwarp();
        }
        if (n == 2) {  // p0 + p1 (the two orders give the same bits)
            mbar_wait(got, (j >> 1) & 1);
            slot_add(sc, slot, t, rank, false, false);
        } else if (n > 2) {  // sum the cluster's n partials of this matrix, in rank order
            slot_wait(got, (j >> 1) & 1, wg, t);
            for (int r = 0; r < n; ++r)
                slot_add(sc, slot, t, r0 + r, unsigned(r0 + r) != rank, r == 0);
        }

        float4* pslot = slots + (3 * buf + 2) * SLOT_F4;
        if (wg == 0) {  // p^T = exp(scale s^T - lse), 0 past Sq; hand it to wg 1
#pragma unroll
            for (int i = 0; i < 16; ++i)
                sc[i] = exp2f(fmaf(sc[i], scale_log2, -rv[2 * (i >> 2) + (i & 1)]));
            if (j >= 2) mbar_wait(&p_free[buf], ((j >> 1) - 1) & 1);
            slot_store(pslot, sc, t);
            mbar_arrive(&p_ready[buf]);
        } else {  // ds^T = scale p^T (dP^T - delta), p^T read as it is used
            mbar_wait(&p_ready[buf], (j >> 1) & 1);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 p = pslot[i * 128 + t];
                const float d0 = rv[2 * i], d1 = rv[2 * i + 1];
                sc[4 * i] = scale * p.x * (sc[4 * i] - d0);
                sc[4 * i + 1] = scale * p.y * (sc[4 * i + 1] - d1);
                sc[4 * i + 2] = scale * p.z * (sc[4 * i + 2] - d0);
                sc[4 * i + 3] = scale * p.w * (sc[4 * i + 3] - d1);
            }
            mbar_arrive(&p_free[buf]);
        }

        // dV += P^T dO_c or dK += dS^T Q_c (dO and Q read MN-major: no transpose)
        const unsigned char* sM = stage(j) + (1 - wg) * CPC * TBOX_BYTES;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) acc_to_a(a[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
            wgmma_m64k16_rs(acc, a[kk], mnmajor_desc(sM + kk * 16 * 128, TBOX_BYTES));
        wgmma_commit();
        if (more) {  // tile j+1's scores are done (tile j's product may still run)
            wgmma_wait<1>();
            fence_operand(sn);
#pragma unroll
            for (int i = 0; i < 16; ++i) sc[i] = sn[i];
#pragma unroll
            for (int i = 0; i < 8; ++i) rv[i] = rn[i];
            to_log2(rv);
        }
    }
    // unconditional: behind a branch, ptxas cannot tell that no group is
    // pending where it is skipped, and serializes the kernel's wgmmas (C7514)
    wgmma_wait<0>();
    fence_operand(acc);
    if (ntiles > 0) mbar_arrive(&empty[(ntiles - 1) % DKV_STAGES]);

    if (halves > 1) {  // dk / dv = the half-0 sums + the half-1 sums, in that order
        float4* stash = reinterpret_cast<float4*>(smem + L.qdo) + wg * (NACC / 4) * 128;
        cluster_sync();  // every tile of the cluster is done: stages and slots are free
        if (half == 1)
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i)
                stash[i * 128 + t] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                                                 acc[4 * i + 3]);
        cluster_sync();
        if (half == 0)
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i) {
                const float4 v = ld_dsmem_f4(&stash[i * 128 + t], rank + n);
                acc[4 * i] += v.x; acc[4 * i + 1] += v.y;
                acc[4 * i + 2] += v.z; acc[4 * i + 3] += v.w;
            }
    }
    bf16* out = wg == 0 ? dv : dk;
    if (half == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = k0 + 16 * w + g + 8 * r;
            if (row >= Sk) continue;
            bf16* orow = out + (((long long)b * Sk + row) * H + h) * D;
#pragma unroll
            for (int i = 0; i < NACC / 4; ++i) {
                const int c = col0 + 8 * i + 2 * tq;
                if (c < D)
                    *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                        __floats2bfloat162_rn(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
            }
        }
    }
    if (clustered) cluster_sync();  // no CTA leaves while a peer may read its shared memory
}

struct Args {
    const void *q, *k, *v, *o, *dO;
    const float* lse;
    float* delta;
    void *dq, *dk, *dv;
    int B, H, Sq, Sk, D;
    long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
    float scale;
    bool vec;
    cudaStream_t st;
};

template <int CPC, bool CLUSTER>
int launch_dq_bf16(const Args& a, int n) {
    constexpr int KT = dq_keys(CPC, CLUSTER);
    const long long o_ss = (long long)a.H * a.D, o_sb = o_ss * a.Sq;  // dO: contiguous BSHD
    CUtensorMap mq, mk, mv, mdo;
    int err = make_map_bshd(&mq, a.q, a.B, a.H, a.Sq, a.D, a.q_sb, a.q_ss, BOX);
    if (!err) err = make_map_bshd(&mk, a.k, a.B, a.H, a.Sk, a.D, a.k_sb, a.k_ss, KT);
    if (!err) err = make_map_bshd(&mv, a.v, a.B, a.H, a.Sk, a.D, a.v_sb, a.v_ss, KT);
    if (!err) err = make_map_bshd(&mdo, a.dO, a.B, a.H, a.Sq, a.D, o_sb, o_ss, BOX);
    if (err) return err;
    constexpr unsigned smem = DqLayout(CPC, KT, CLUSTER).total;
    if (const int e = allow_smem<flash_bwd_dq_bf16<CPC, KT, CLUSTER>>(smem)) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n * ((a.Sq + BOX - 1) / BOX), a.B * a.H);
    cfg.blockDim = dim3(DQ_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = a.st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, flash_bwd_dq_bf16<CPC, KT, CLUSTER>, mq, mk, mv, mdo,
        static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dO), a.lse, a.delta,
        static_cast<bf16*>(a.dq), a.H, a.Sq, a.Sk, a.D, n, a.scale, a.scale * LOG2E);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Query halves: two when the grid of key blocks would not fill the card once
// (the U-Net's 512-token sites, a short context), so that twice the CTAs each
// walk half the queries; only where there are two query tiles to split.
int pick_halves(const Args& a, int n) {
    static int sms = 0;  // the SMs of the first device this runs on
    int dev = 0;
    if (!sms && (cudaGetDevice(&dev) != cudaSuccess ||
                 cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess))
        return 1;
    const long long ctas = (long long)a.B * a.H * ((a.Sk + BOX - 1) / BOX) * n;
    return 2 * ctas <= sms && a.Sq > TILE ? 2 : 1;
}

template <int CPC>
int launch_dkdv_bf16(const Args& a, int n) {
    const long long o_ss = (long long)a.H * a.D, o_sb = o_ss * a.Sq;  // dO: contiguous BSHD
    CUtensorMap mq, mk, mv, mdo;
    int err = make_map_bshd(&mq, a.q, a.B, a.H, a.Sq, a.D, a.q_sb, a.q_ss, TILE);
    if (!err) err = make_map_bshd(&mk, a.k, a.B, a.H, a.Sk, a.D, a.k_sb, a.k_ss, BOX);
    if (!err) err = make_map_bshd(&mv, a.v, a.B, a.H, a.Sk, a.D, a.v_sb, a.v_ss, BOX);
    if (!err) err = make_map_bshd(&mdo, a.dO, a.B, a.H, a.Sq, a.D, o_sb, o_ss, TILE);
    if (err) return err;
    const unsigned smem = DkvLayout(CPC).total;
    if (const int e = allow_smem<flash_bwd_dkdv_bf16<CPC>>(smem)) return e;
    cudaLaunchConfig_t cfg = {};
    const int halves = pick_halves(a, n);
    cfg.gridDim = dim3(n * halves * ((a.Sk + BOX - 1) / BOX), a.B * a.H);
    cfg.blockDim = dim3(DKV_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = a.st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n * halves;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, flash_bwd_dkdv_bf16<CPC>, mq, mk, mv, mdo, a.lse, (const float*)a.delta,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.Sq, a.Sk, a.D, n, halves,
        a.scale, a.scale * LOG2E);
    if (e != cudaSuccess) return (int)e;
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
                 float* __restrict__ delta, float* __restrict__ dq, int H, int Sq, int Sk,
                 int D,
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
    const int q0 = blockIdx.x * BQ32, nq = min(BQ32, Sq - q0);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long o_ss = (long long)H * D;
    const long long o_base = ((long long)b * Sq * H + h) * D;
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
            sLse[r] = r < nq ? lse[(long long)bh * Sq + q0 + r] : 0.f;
            if (r < nq) delta[(long long)bh * Sq + q0 + r] = acc;
        }
    }

    for (int k0 = 0; k0 < Sk; k0 += BQ32) {
        const int nk = min(BQ32, Sk - k0);
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
                   float* __restrict__ dk, float* __restrict__ dv, int H, int Sq, int Sk,
                   int D,
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
    const int k0 = blockIdx.x * BK32, nk = min(BK32, Sk - k0);
    const long long o_ss = (long long)H * D;
    const long long o_base = ((long long)b * Sq * H + h) * D;  // dO: (B, Sq, H, D)
    const long long k_base = ((long long)b * Sk * H + h) * D;  // dk, dv: (B, Sk, H, D)
    const float* qb = q + b * q_sb + (long long)h * D;
    const float* kb = k + b * k_sb + (long long)h * D;
    const float* vb = v + b * v_sb + (long long)h * D;

    load_tile_f32(sK, ldt, kb + k0 * k_ss, k_ss, nk, BK32, D, Dp);
    load_tile_f32(sV, ldt, vb + k0 * v_ss, v_ss, nk, BK32, D, Dp);
    for (int i = threadIdx.x; i < BK32 * ldt; i += NTHREADS) { sdK[i] = 0.f; sdV[i] = 0.f; }

    for (int i0 = 0; i0 < Sq; i0 += BQ32) {
        const int nq = min(BQ32, Sq - i0);
        __syncthreads();
        load_tile_f32(sQ, ldt, qb + i0 * q_ss, q_ss, nq, BQ32, D, Dp);
        load_tile_f32(sdO, ldt, dO + o_base + i0 * o_ss, o_ss, nq, BQ32, D, Dp);
        for (int c = threadIdx.x; c < BQ32; c += NTHREADS) {
            sLse[c] = c < nq ? lse[(long long)bh * Sq + i0 + c] : 0.f;
            sDelta[c] = c < nq ? delta[(long long)bh * Sq + i0 + c] : 0.f;
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
        const long long at = k_base + (k0 + r) * o_ss + d;
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
        const dim3 grid((a.Sq + BQ32 - 1) / BQ32, a.B * a.H);
        flash_bwd_dq_f32<<<grid, NTHREADS, smem, a.st>>>(
            q, k, v, static_cast<const float*>(a.o), dO, a.lse, a.delta,
            static_cast<float*>(a.dq), a.H, a.Sq, a.Sk, a.D, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb,
            a.v_ss, a.scale);
    } else {
        const dim3 grid((a.Sk + BK32 - 1) / BK32, a.B * a.H);
        flash_bwd_dkdv_f32<<<grid, NTHREADS, smem, a.st>>>(
            q, k, v, dO, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
            a.H, a.Sq, a.Sk, a.D, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.scale);
    }
    return (int)cudaGetLastError();
}

size_t smem_bytes(int D, int dtype) {
    if (dtype == 1) {
        if (D > MAX_D) return ~size_t(0);
        const Split sq(D);
        const bool cl = sq.n > 1;
        const size_t a = DqLayout(sq.cpc, dq_keys(sq.cpc, cl), cl).total;
        const size_t b = DkvLayout(DkvSplit(D).cpc).total;
        return a > b ? a : b;
    }
    const LayoutF32 L(D);
    return L.dq_total > L.dkv_total ? L.dq_total : L.dkv_total;
}

int run(const Args& a, int dtype, bool dq_pass) {
    if (a.D < 1 || a.Sq < 1 || a.Sk < 1 || smem_bytes(a.D, dtype) > MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    if (dtype == 0) return launch_f32(a, dq_pass);
    // bf16: TMA needs aligned bases and 8-element strides (the caller copies other inputs)
    if (dtype != 1 || !a.vec) return (int)cudaErrorInvalidValue;
    if (dq_pass) {
        const Split sp(a.D);
        if (sp.n > 1)  // n > 1 only from D = 513, where cpc is 3
            return sp.cpc == 3 ? launch_dq_bf16<3, true>(a, sp.n) : (int)cudaErrorInvalidValue;
        switch (sp.cpc) {
            case 1: return launch_dq_bf16<1, false>(a, 1);
            case 2: return launch_dq_bf16<2, false>(a, 1);
            case 3: return launch_dq_bf16<3, false>(a, 1);
            case 4: return launch_dq_bf16<4, false>(a, 1);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    const DkvSplit sp(a.D);
    switch (sp.cpc) {
        case 1: return launch_dkdv_bf16<1>(a, sp.n);
        case 2: return launch_dkdv_bf16<2>(a, sp.n);
        case 3: return launch_dkdv_bf16<3>(a, sp.n);
        case 4: return launch_dkdv_bf16<4>(a, sp.n);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory the larger of the two kernels needs at head dim D
// (dtype 0 = f32, 1 = bf16).
long long medimgen_flash_attn_bwd_smem_bytes(int D, int dtype) {
    return (long long)smem_bytes(D, dtype);
}

// q: element (b, s, h, d) at base + b*sb + s*ss + h*D + d for s < Sq; k, v
// the same for s < Sk. o, dO and dq: contiguous (B, Sq, H, D), dk and dv:
// contiguous (B, Sk, H, D), of q's dtype; lse, delta: contiguous f32 (B*H,
// Sq). vec != 0 (bf16): every base pointer is 16-byte aligned and D and all
// strides are multiples of 8 elements.
// The dq pass writes dq and delta; the dk/dv pass reads delta and must run
// after it on the same stream. Each returns the cudaError_t code.
int medimgen_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dO, const float* lse, float* delta, void* dq,
                               int B, int H, int Sq, int Sk, int D, int dtype,
                               long long q_sb,
                               long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                               long long v_ss, float scale, int vec, void* stream) {
    const Args a{q, k, v, o, dO, lse, delta, dq, nullptr, nullptr, B, H, Sq, Sk, D, q_sb,
                 q_ss, k_sb, k_ss, v_sb, v_ss, scale, vec != 0,
                 static_cast<cudaStream_t>(stream)};
    return run(a, dtype, true);
}

int medimgen_flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dO,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 int B, int H, int Sq, int Sk, int D, int dtype,
                                 long long q_sb,
                                 long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                                 long long v_ss, float scale, int vec, void* stream) {
    const Args a{q, k, v, nullptr, dO, lse, const_cast<float*>(delta), nullptr, dk, dv, B, H,
                 Sq, Sk, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, vec != 0,
                 static_cast<cudaStream_t>(stream)};
    return run(a, dtype, false);
}

}  // extern "C"
