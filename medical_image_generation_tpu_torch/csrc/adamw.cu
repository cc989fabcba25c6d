// clip_by_global_norm + AdamW over a list of tensors, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces no TPU kernel. In the JAX package optax's `clip_by_global_norm`
// and `adamw` (medical_image_generation_tpu/training/common.py) are plain
// array code that XLA fuses into a few passes over the state. Eager PyTorch
// runs the same mathematics as ~22 `torch._foreach_*` ops, each a full pass
// over the state (~180 bytes a parameter with a bf16 first moment), plus a
// launch per tensor and op chunk; these two kernels do it in two passes:
//
// sq_norm (medimgen_adamw_sq_norm): one read of every gradient (4 B a
//   parameter). Each block writes two fp32 partial sums of squares, the
//   Megatron-sharded tensors' and the replicated ones' (as `global_norm`
//   splits them); the last block to finish, picked by an atomic ticket, sums
//   the partials in block order into sums[0..1]. No float atomics, so the
//   norm is the same in every run.
// adamw_update (medimgen_adamw_update): reads g, p, mu and nu and writes p,
//   mu and nu (4+4+2+4 + 4+2+4 = 24 B a parameter with a bf16 mu). The norm
//   is sqrt(sums[0] + sums[1]), read from device memory, so an all-reduce of
//   sums[0] over the model axis can run between the passes without a host
//   read. Per element it makes the plain version's fp32 operations in the
//   plain version's order (ops/adamw.py `clip_by_global_norm` and
//   `adamw_plain_`), each rounded on its own: the `__f*_rn` intrinsics keep
//   nvcc from contracting a product and a sum into one FMA.
//
// Both are bound by bytes: 28 B a parameter at 3.35 TB/s (the 3D U-Net's
// 441M parameters: 3.69 ms). Each reads the gradients once. A persistent
// grid (BLOCKS_PER_SM blocks an SM) walks one index space of TILE-element
// tiles over all the tensors of a launch, in order; a thread moves 16 bytes
// of each fp32 tensor (8 of a bf16 mu) a load, with the next loads of its
// tile in flight, and a tensor's last numel % 4 elements (or a whole tensor
// whose addresses are not 16-byte aligned) go one element at a time.
//
// The tensors' addresses, sizes and tile offsets travel by value in the
// launch parameters (AdamwTable, 17 KB: sm_90 with CUDA >= 12.1 takes 32 KB),
// as PyTorch's multi_tensor_apply does: no table is copied to the device, so
// nothing waits on the host. A list longer than MAX_TENSORS takes several
// launches of each kernel; the sq_norm launches after the first add to sums.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_TENSORS = 384;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int NORM_UNROLL = 4;   // 16-byte gradient loads in flight a thread (sq_norm)
constexpr int UPDATE_UNROLL = 2; // groups of 4 elements in flight a thread (update)
constexpr int TILE = THREADS * 4 * NORM_UNROLL;  // 4096 elements
static_assert(TILE % (THREADS * 4 * UPDATE_UNROLL) == 0, "a tile is whole update sweeps");

enum : unsigned char { SHARDED = 1, VEC = 2 };

}  // namespace

extern "C" {

// The tensors of one launch. Tensor i owns tiles [tile_start[i],
// tile_start[i + 1]) of the launch; tile k of it holds its elements
// [k * TILE, min((k + 1) * TILE, numel[i])). g[i] == 0: no gradient (read as
// zeros). flags[i]: SHARDED (its squares go to sums[0]), VEC (every address
// of it is aligned for 16-byte loads of fp32 and 8-byte loads of a bf16 mu).
// p, g and nu are fp32, mu fp32 or bf16; all four share one dense layout.
struct AdamwTable {
    uint64_t g[MAX_TENSORS];
    uint64_t p[MAX_TENSORS];
    uint64_t mu[MAX_TENSORS];
    uint64_t nu[MAX_TENSORS];
    long long numel[MAX_TENSORS];
    int tile_start[MAX_TENSORS + 1];
    int n;
    unsigned char flags[MAX_TENSORS];
};

// The step's scalars, each the fp32 value the plain version's PyTorch ops
// use: b1_mu is b1 rounded to mu's dtype; inv_bc1, inv_bc2 the reciprocals of
// the bias corrections, since `_foreach_div` by a scalar multiplies by the
// reciprocal (taken in double, then rounded to fp32) on CUDA.
struct AdamwHyper {
    float max_norm, b1_mu, one_minus_b1, b2, one_minus_b2, inv_bc1, inv_bc2, eps, wd, neg_lr;
    int clip, has_wd;
};

}  // extern "C"

namespace {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// The block's sum of x, the same on every thread, in a fixed order.
__device__ __forceinline__ float block_sum(float x, float* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    x = warp_sum(x);
    __syncthreads();  // sh may still be read from an earlier call
    if (lane == 0) sh[warp] = x;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += sh[w];
    return s;
}

// The tensor owning `tile`, walking forward from i (a block's tiles rise).
__device__ __forceinline__ int owner(const AdamwTable& t, int tile, int i) {
    while (t.tile_start[i + 1] <= tile) ++i;
    return i;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
adamw_sq_norm_kernel(const __grid_constant__ AdamwTable t, float* __restrict__ partials,
                     float* __restrict__ sums, unsigned int* __restrict__ ticket,
                     int accumulate) {
    __shared__ float sh[THREADS / 32];
    __shared__ bool last;
    const int tid = threadIdx.x;
    const int total = t.tile_start[t.n];
    float acc_sharded = 0.f, acc_rep = 0.f;
    int i = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        i = owner(t, tile, i);
        const float* g = reinterpret_cast<const float*>(t.g[i]);
        if (g == nullptr) continue;
        const long long n = t.numel[i];
        const long long a = (long long)(tile - t.tile_start[i]) * TILE;
        const long long b = min(a + TILE, n);
        const long long vend = min(b, (t.flags[i] & VEC) ? (n & ~3LL) : 0LL);
        float s = 0.f;
        if (a < vend) {  // a whole tile is one sweep
            float4 x[NORM_UNROLL];
#pragma unroll
            for (int u = 0; u < NORM_UNROLL; ++u) {
                const long long e = a + (long long)(u * THREADS + tid) * 4;
                x[u] = e < vend ? __ldcs(reinterpret_cast<const float4*>(g + e))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < NORM_UNROLL; ++u) {
                s = fmaf(x[u].x, x[u].x, s);
                s = fmaf(x[u].y, x[u].y, s);
                s = fmaf(x[u].z, x[u].z, s);
                s = fmaf(x[u].w, x[u].w, s);
            }
        }
        for (long long e = max(a, vend) + tid; e < b; e += THREADS) {
            const float x = __ldcs(g + e);
            s = fmaf(x, x, s);
        }
        if (t.flags[i] & SHARDED) acc_sharded += s;
        else acc_rep += s;
    }
    const float b0 = block_sum(acc_sharded, sh);
    const float b1 = block_sum(acc_rep, sh);
    if (tid == 0) {
        partials[2 * blockIdx.x] = b0;
        partials[2 * blockIdx.x + 1] = b1;
        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    // the last block: every partial is written; sum them in block order
    float f0 = 0.f, f1 = 0.f;
    for (int k = tid; k < (int)gridDim.x; k += THREADS) {
        f0 += __ldcg(partials + 2 * k);
        f1 += __ldcg(partials + 2 * k + 1);
    }
    f0 = block_sum(f0, sh);
    f1 = block_sum(f1, sh);
    if (tid == 0) {
        sums[0] = accumulate ? sums[0] + f0 : f0;
        sums[1] = accumulate ? sums[1] + f1 : f1;
        *ticket = 0u;  // ready for the next launch
    }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename M> __device__ __forceinline__ M from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ void load4(const float* q, float (&f)[4]) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(q));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* q, float (&f)[4]) {
    const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(q));
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = __bfloat162float(e[k]);
}
__device__ __forceinline__ void store4(float* q, const float (&f)[4]) {
    __stcs(reinterpret_cast<float4*>(q), make_float4(f[0], f[1], f[2], f[3]));
}
__device__ __forceinline__ void store4(bf16* q, const float (&f)[4]) {
    uint2 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = __float2bfloat16_rn(f[k]);
    __stcs(reinterpret_cast<uint2*>(q), raw);
}

// One element, in the plain version's order. mu in: the stored moment; out:
// the fp32 moment m (stored rounded to M). d, mx: the clip's divisor and
// factor (1 and 1 when the norm is under max_norm).
template <typename M>
__device__ __forceinline__ void adam(float g, float& p, float& mu, float& nu,
                                     const AdamwHyper& h, float d, float mx) {
    g = __fmul_rn(__fdiv_rn(g, d), mx);
    const float mu_s = to_f(from_f<M>(__fmul_rn(mu, h.b1_mu)));  // b1 * mu in mu's dtype
    const float m = __fadd_rn(mu_s, __fmul_rn(g, h.one_minus_b1));
    const float v = __fadd_rn(__fmul_rn(nu, h.b2), __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
    float u = __fdiv_rn(__fmul_rn(m, h.inv_bc1), den);
    if (h.has_wd) u = __fadd_rn(u, __fmul_rn(p, h.wd));
    p = __fadd_rn(p, __fmul_rn(u, h.neg_lr));
    mu = m;
    nu = v;
}

template <typename M>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
adamw_update_kernel(const __grid_constant__ AdamwTable t, const __grid_constant__ AdamwHyper h,
                    const float* __restrict__ sums, float* __restrict__ norm_out) {
    const int tid = threadIdx.x;
    float d = 1.f, mx = 1.f;
    if (h.clip) {
        const float norm = __fsqrt_rn(__fadd_rn(sums[0], sums[1]));
        if (!(norm < h.max_norm)) {  // a NaN norm clips, as where(norm < max, ...) does
            d = norm;
            mx = h.max_norm;
        }
        if (blockIdx.x == 0 && tid == 0) *norm_out = norm;
    }
    const int total = t.tile_start[t.n];
    int i = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        i = owner(t, tile, i);
        const float* g = reinterpret_cast<const float*>(t.g[i]);
        float* p = reinterpret_cast<float*>(t.p[i]);
        M* mu = reinterpret_cast<M*>(t.mu[i]);
        float* nu = reinterpret_cast<float*>(t.nu[i]);
        const long long n = t.numel[i];
        const long long a = (long long)(tile - t.tile_start[i]) * TILE;
        const long long b = min(a + TILE, n);
        const long long vend = min(b, (t.flags[i] & VEC) ? (n & ~3LL) : 0LL);
        for (long long base = a; base < vend; base += THREADS * 4 * UPDATE_UNROLL) {
            float gv[UPDATE_UNROLL][4], pv[UPDATE_UNROLL][4], mv[UPDATE_UNROLL][4],
                nv[UPDATE_UNROLL][4];
#pragma unroll
            for (int u = 0; u < UPDATE_UNROLL; ++u) {
                const long long e = base + (long long)(u * THREADS + tid) * 4;
                if (e < vend) {
                    if (g != nullptr) load4(g + e, gv[u]);
                    else gv[u][0] = gv[u][1] = gv[u][2] = gv[u][3] = 0.f;
                    load4(p + e, pv[u]);
                    load4(mu + e, mv[u]);
                    load4(nu + e, nv[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < UPDATE_UNROLL; ++u) {
                const long long e = base + (long long)(u * THREADS + tid) * 4;
                if (e < vend) {
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        adam<M>(gv[u][k], pv[u][k], mv[u][k], nv[u][k], h, d, mx);
                    store4(p + e, pv[u]);
                    store4(mu + e, mv[u]);
                    store4(nu + e, nv[u]);
                }
            }
        }
        for (long long e = max(a, vend) + tid; e < b; e += THREADS) {
            float pe = p[e], me = to_f(mu[e]), ne = nu[e];
            adam<M>(g != nullptr ? g[e] : 0.f, pe, me, ne, h, d, mx);
            p[e] = pe;
            mu[e] = from_f<M>(me);
            nu[e] = ne;
        }
    }
}

// The table's tile offsets cover its tensors, and its VEC flags hold: g, p
// and nu 16-byte aligned, mu aligned for 4 of its elements (mu_bytes 4 or 2;
// 0: mu is not read).
bool table_ok(const AdamwTable& t, int mu_bytes) {
    if (t.n < 1 || t.n > MAX_TENSORS || t.tile_start[0] != 0) return false;
    for (int i = 0; i < t.n; ++i) {
        if (t.numel[i] < 0 ||
            (long long)t.tile_start[i + 1] - t.tile_start[i] != (t.numel[i] + TILE - 1) / TILE)
            return false;
        if ((t.flags[i] & VEC) &&
            ((t.g[i] | t.p[i] | t.nu[i]) % 16 != 0 || (mu_bytes && t.mu[i] % (4 * mu_bytes) != 0)))
            return false;
    }
    return true;
}

}  // namespace

extern "C" {

// Sizes the wrapper's ctypes mirror checks: [sizeof(AdamwTable),
// sizeof(AdamwHyper), MAX_TENSORS, TILE, THREADS, BLOCKS_PER_SM].
void medimgen_adamw_layout(long long* out) {
    out[0] = sizeof(AdamwTable);
    out[1] = sizeof(AdamwHyper);
    out[2] = MAX_TENSORS;
    out[3] = TILE;
    out[4] = THREADS;
    out[5] = BLOCKS_PER_SM;
}

// partials: fp32 scratch of 2 * grid floats; sums: 2 fp32 ([sharded,
// replicated] sums of squares), overwritten, or added to when accumulate;
// ticket: a uint32 that is 0 between launches. Returns the cudaError_t code.
int medimgen_adamw_sq_norm(const AdamwTable* t, float* partials, float* sums,
                           unsigned int* ticket, int grid, int accumulate, void* stream) {
    if (grid < 1 || !table_ok(*t, 0)) return (int)cudaErrorInvalidValue;
    adamw_sq_norm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        *t, partials, sums, ticket, accumulate);
    return (int)cudaGetLastError();
}

// mu_dtype 0 = fp32, 1 = bf16. sums: as sq_norm left them (read when
// h->clip); norm_out: fp32 scalar, written with the norm when h->clip.
int medimgen_adamw_update(const AdamwTable* t, const AdamwHyper* h, const float* sums,
                          float* norm_out, int mu_dtype, int grid, void* stream) {
    if (grid < 1 || (mu_dtype != 0 && mu_dtype != 1) || !table_ok(*t, mu_dtype ? 2 : 4))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (mu_dtype == 1)
        adamw_update_kernel<bf16><<<grid, THREADS, 0, st>>>(*t, *h, sums, norm_out);
    else
        adamw_update_kernel<float><<<grid, THREADS, 0, st>>>(*t, *h, sums, norm_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
