// Flash-attention forward for Hopper (sm_90a) at head dims up to 64, plain C
// interface for ctypes.
//
// Replaces, at small head dims, the TPU kernel `_flash_kernel` /
// `_flash_forward` in medical_image_generation_tpu/ops/pallas_attention.py
// (:61-184), as flash_attn_fwd.cu does at the wide ones: softmax(scale Q K^T) V
// over (B*H, Sq, D) queries and (B*H, Sk, D) keys and values with an online
// softmax across key tiles, f32 m, l and O, writing O (bf16, Sq rows) and the
// f32 row logsumexp (B*H, Sq) the backward reads. Same interface and outputs
// as flash_attn_fwd.cu; ops/flash_attention.py sends bf16 inputs whose head
// dim, padded to 8, is at most 64 here (MAISI's heads of 32).
//
// Bounds on this card at MAISI's (1, 32768, 8, 32): 4*B*H*Sq*Sk*D = 1.1e12
// FLOP at 989 TFLOP/s (bf16 tensor cores) is 1.11 ms; B*H*Sq*Sk = 8.6e9
// exponentials at ~3.9e12/s (the special-function units: 16 a clock an SM) is
// 2.2 ms. At D = 32 the exponential, not the tensor cores, is the floor;
// the bytes (Q, K, V, O once) are ~0.01 ms.
//
// Why not flash_attn_fwd.cu: it splits D into 64-column chunks over two
// warpgroups that exchange partial scores through shared memory every 32-key
// tile. At D = 32 one chunk is half zero fill, the other warpgroup holds only
// padding, and every tile pays the exchange.
//
// Design (bf16 only; the fp32 path stays in flash_attn_fwd.cu):
//   * a CTA of NWG consumer warpgroups and one producer warp; warpgroup w owns
//     64 query rows of one (batch, head) and all DP = 32 or 64 columns of the
//     padded head dim (an O accumulator of 16 or 32 floats a thread). No
//     split of D, no exchange between warpgroups, no cluster.
//   * the producer's one thread loads each warpgroup's Q box once and 64-key
//     K and V tiles through TMA into a ring of STAGES stages shared by all
//     warpgroups (64-byte swizzle at DP = 32, 128-byte at 64; zero fill past
//     Sq, Sk and D); each consumer warp releases a stage with one arrival.
//   * S = Q K^T is m64n64k16 over DP/16 k-steps, both operands K-major; the
//     softmax runs in registers in exp2 units with the scale folded in (row
//     max and sum over a quad's shuffles), exponentials by ex2.approx; P goes
//     from the score registers, rounded to bf16, into the A operand of
//     O += P V (m64nDPk16, V read MN-major: nothing is transposed).
//   * one tile's P V runs on the tensor cores behind the next tile's scores:
//     a warpgroup issues S_j = Q K_j^T, then O += P_{j-1} V_{j-1}, waits for
//     S_j alone, and computes P_j (the exponentials) while P_{j-1} V_{j-1}
//     runs; then it waits for that, releases stage j-1 and rescales O. Across
//     the NWG warpgroups of an SM the scheduler overlaps one's exponentials
//     with another's products.
//   * only the last, partial key tile is masked (keys past Sk get -inf; a
//     context shorter than one tile is one partial tile); query rows past Sq
//     are computed on zero fill and not stored.
// NWG = 4 at DP = 32 (256 query rows a CTA, 544 threads, 90 registers a
// thread): the more warpgroups an SM holds, the more of them have
// exponentials ready while others wait on a product. Timed on the card at
// (1, 32768, 8, 32): NWG = 3 5.63-5.70 ms, 4 4.78-4.80, 5 6.62 (spills: the
// cap is 16,384 / (32 (NWG + 1)) registers, the SM sub-partition that holds
// the producer warp beside one warp of each consumer warpgroup). NWG = 3 at
// DP = 64 (106 registers; at 4 its cap of 102 spills). Shared memory at DP =
// 32: Q 16 KB, four K/V stages 32 KB.
//
// Not yet: ping-pong of the warpgroups on named barriers (FA3's scheduling),
// a persistent grid, TMA stores of O.

#include "flash_narrow.cuh"

namespace {

constexpr int KT = 64;      // keys a tile
constexpr int STAGES = 4;   // K/V ring depth

template <int DP, int NWG>
struct NarrowFwdLayout {
    static constexpr unsigned QBOX = 64 * 2 * DP;    // one warpgroup's 64 query rows
    static constexpr unsigned KVBOX = KT * 2 * DP;   // one K or V tile
    static constexpr unsigned q = 0;                  // warpgroup w's Q at w * QBOX
    static constexpr unsigned kv = NWG * QBOX;        // stage s: K at 2s boxes, V at 2s + 1
    static constexpr unsigned bars = kv + STAGES * 2 * KVBOX;  // full[], empty[], q
    static constexpr unsigned total = bars + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

template <int DP, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_narrow_bf16(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Sk, int D, float scale_log2) {
    using L = NarrowFwdLayout<DP, NWG>;
    constexpr int KS = DP / 16;   // k16 steps of Q K^T
    constexpr int NS = KT / 2;    // score floats a thread (64 x KT)
    constexpr int NO = DP / 2;    // O floats a thread (64 x DP)
    constexpr int KK = KT / 16;   // k16 steps of P V
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* empty = full + STAGES;
    uint64_t* qbar = empty + STAGES;

    const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
    const int q0 = blockIdx.x * NWG * 64;
    const int ntiles = (Sk + KT - 1) / KT;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], NWG * 4);
        }
        mbar_init(qbar, 1);
        mbar_init_fence();
    }
    __syncthreads();

    if (threadIdx.x >= NWG * 128) {  // ---- producer warp: one thread feeds Q and the K/V ring
        if (threadIdx.x == NWG * 128) {
            mbar_expect_tx(qbar, NWG * L::QBOX);
#pragma unroll 1
            for (int w = 0; w < NWG; ++w)
                tma_load_box(smem + L::q + w * L::QBOX, &mq, 0, h, q0 + 64 * w, b, qbar);
#pragma unroll 1
            for (int j = 0; j < ntiles; ++j) {
                const int s = j % STAGES;
                if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
                unsigned char* sK = smem + L::kv + 2 * s * L::KVBOX;
                mbar_expect_tx(&full[s], 2 * L::KVBOX);
                tma_load_box(sK, &mk, 0, h, j * KT, b, &full[s]);
                tma_load_box(sK + L::KVBOX, &mv, 0, h, j * KT, b, &full[s]);
            }
        }
        return;
    }

    // ---- consumer warpgroups: 64 query rows each, rows g and g + 8 of warp w's 16
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int w = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
    const unsigned char* sQ = smem + L::q + wg * L::QBOX;
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    unsigned pa[KK][4];  // the previous tile's P, bf16 A fragments
    mbar_wait(qbar, 0);

#pragma unroll 1
    for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        const unsigned char* sK = smem + L::kv + 2 * s * L::KVBOX;
        mbar_wait(&full[s], (j / STAGES) & 1);

        float sc[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            wgmma_scores(sc, narrow_kmajor<DP>(sQ + 32 * kk), narrow_kmajor<DP>(sK + 32 * kk),
                         kk > 0);
        wgmma_commit();
        if (j > 0) {  // O += P V of the previous tile, behind this tile's scores
            const unsigned char* sV = smem + L::kv + (2 * ((j - 1) % STAGES) + 1) * L::KVBOX;
#pragma unroll
            for (int kk = 0; kk < KK; ++kk)
                wgmma_m64k16_rs(acc, pa[kk], narrow_mnmajor<DP>(sV + kk * 16 * 2 * DP));
            wgmma_commit();
            wgmma_wait<1>();
        } else {
            wgmma_wait<0>();
        }
        fence_operand(sc);

        // online softmax in registers (log2 units)
        const int k0 = j * KT;
        if (k0 + KT > Sk) {
#pragma unroll
            for (int i = 0; i < NS; ++i)
                if (k0 + 8 * (i >> 2) + 2 * tq + (i & 1) >= Sk) sc[i] = -INFINITY;
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r] * scale_log2);
            corr[r] = ex2(m[r] - m_new);
            m[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const int r = (i >> 1) & 1;
            sc[i] = ex2(fmaf(sc[i], scale_log2, -m[r]));
            ls[r] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 1);
            ls[r] += __shfl_xor_sync(0xffffffffu, ls[r], 2);
            l[r] = l[r] * corr[r] + ls[r];
        }
        unsigned pn[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) acc_to_a(pn[kk], sc, kk);

        if (j > 0) {  // the previous tile's P V is done: its stage and pa are free
            wgmma_wait<0>();
            fence_operand(pa);
            if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
        }
        fence_operand(acc);
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
    }

    // the last tile's P V
    const unsigned char* sV = smem + L::kv + (2 * ((ntiles - 1) % STAGES) + 1) * L::KVBOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
        wgmma_m64k16_rs(acc, pa[kk], narrow_mnmajor<DP>(sV + kk * 16 * 2 * DP));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);

    // O = acc / l into (B, Sq, H, D); lse = m + log(l) into (B*H, Sq)
    const int row0 = q0 + 64 * wg;
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    store_rows(o, acc, inv, b, h, H, Sq, D, row0, w, g, tq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * w + g + 8 * r;
        if (row < Sq && tq == 0) lse[(long long)bh * Sq + row] = (m[r] + log2f(l[r])) * LN2;
    }
}

template <int DP, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int Sq,
           int Sk, int D, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, float scale, cudaStream_t st) {
    CUtensorMap mq, mk, mv;
    int err = make_map_narrow<DP>(&mq, q, B, H, Sq, D, q_sb, q_ss, 64);
    if (!err) err = make_map_narrow<DP>(&mk, k, B, H, Sk, D, k_sb, k_ss, KT);
    if (!err) err = make_map_narrow<DP>(&mv, v, B, H, Sk, D, v_sb, v_ss, KT);
    if (err) return err;
    constexpr unsigned smem = NarrowFwdLayout<DP, NWG>::total;
    if (const int e = allow_smem<flash_fwd_narrow_bf16<DP, NWG>>(smem)) return e;
    const dim3 grid((Sq + NWG * 64 - 1) / (NWG * 64), B * H);
    flash_fwd_narrow_bf16<DP, NWG><<<grid, NWG * 128 + 32, smem, st>>>(
        mq, mk, mv, static_cast<bf16*>(o), lse, H, Sq, Sk, D, scale * LOG2E);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of medimgen_flash_attn_fwd (flash_attn_fwd.cu): q, k, v with
// element (b, s, h, d) at base + b*sb + s*ss + h*D + d; o contiguous (B, Sq,
// H, D), lse contiguous f32 (B*H, Sq). Takes bf16 (dtype 1) with vec != 0
// (16-byte aligned bases, D and strides multiples of 8) and D <= 64 only.
// Returns the cudaError_t code.
int medimgen_flash_narrow_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int H, int Sq, int Sk, int D, int dtype, long long q_sb,
                              long long q_ss, long long k_sb, long long k_ss, long long v_sb,
                              long long v_ss, float scale, int vec, void* stream) {
    if (dtype != 1 || !vec || D < 1 || D > NARROW_MAX_D || Sq < 1 || Sk < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MEDIMGEN_ARGS q, k, v, o, lse, B, H, Sq, Sk, D, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, st
    return D <= 32 ? launch<32, 4>(MEDIMGEN_ARGS) : launch<64, 3>(MEDIMGEN_ARGS);
#undef MEDIMGEN_ARGS
}

}  // extern "C"
