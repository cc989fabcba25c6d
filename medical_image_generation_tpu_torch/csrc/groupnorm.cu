// GroupNorm passes for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels in medical_image_generation_tpu/ops/pallas_groupnorm.py:
//   * channel stats: `_stats_kernel` / `lane_stats` (:94-124) and
//     `_stats_any_kernel` / `lane_stats_any` (:127-184). The two TPU kernels
//     compute the same function and differ only in TPU memory placement, so
//     one kernel here serves both.
//   * the group fold after them, `_fold_affine` (:226-241). In JAX it is
//     plain array code that XLA fuses; in eager PyTorch it would be ~11 small
//     launches per GroupNorm, and the host's launch rate is what bounds the
//     U-Net forward, so it runs in the stats pass's second launch here.
//   * affine + activation: `_affine_kernel` / `affine_act` (:187-223).
//
// Both operate on a (B, M, C) activation, which is how a channels-last NCDHW
// tensor lies in memory (M = Z*Y*X), for any M and any C.
//
// stats + fold (medimgen_gn_stats_fold), two launches: per (batch, channel)
//   fp32 [sum x, sum x^2] over M, then the group statistics folded into
//   A = w * rsqrt(var + eps), b = bias - mean * A per (batch, channel). The
//   activation is read once: each block of the first launch reduces a slab
//   of rows for a tile of channels and writes one fp32 partial; the second
//   launch, a block per (group, batch), sums its channels' partials in slab
//   order, writes the channel sums (the backward reads them) and folds them.
//   No float atomics, so repeated runs give bit-identical statistics (and
//   samples). The fold is a few KB a GroupNorm: sharing the reduce's launch
//   saves a launch and a wrapper call on a host-bound path.
//   Bound: bytes, B*M*C*itemsize at 3.35 TB/s.
// affine_act: y = act(x * A[b, c] + b[b, c]) with fp32 math and one rounding
//   at the store; act is SiLU or none. One read and one write.
//   Bound: bytes, B*M*C*(in + out itemsize) at 3.35 TB/s.
//
// The stats pass streams the activation at HBM rate: each thread loads 16
// bytes of a row (8 bf16 or 4 f32 channels) where C and the base pointer
// allow it, else one element, and keeps STATS_UNROLL independent row loads
// in flight. A warp reads 512 contiguous bytes: 32 lanes along a row, or at
// small C (32 bf16 channels: 4 lanes a row) several whole rows. The caller
// sizes the grid from the SM count (`_stats_slabs` in ops/groupnorm.py), so
// that every shape of the flagship paths fills the card, C = 32 included.
// affine_act uses 16-byte vector accesses when C and the pointers allow it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

constexpr int STATS_THREADS = 256;
constexpr int STATS_UNROLL = 4;  // independent row loads in flight a thread
constexpr int FOLD_THREADS = 512;
constexpr int MAX_GROUP_CHANNELS = 4096;  // the fold's shared memory: 8 * Cg bytes

// V channels of one row from 16 bytes (V = 16 / sizeof(T)) or one element (V = 1).
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* p, float (&f)[V]) {
    if constexpr (V == 1) {
        f[0] = to_f(*p);
    } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(p);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = to_f(e[i]);
    }
}

// Partial [sum x, sum x^2] of V adjacent channels over a slab of rows.
// grid (ceil(C / (V * CTV)), nblk, B); block (CTV, RY): thread (tx, ty) owns
// channels [(blockIdx.x * CTV + tx) * V, +V) and rows m0 + ty, m0 + ty + RY, ...
// of its block's slab, STATS_UNROLL loads in flight; the block then sums its
// RY row lanes in order. partials: (B, nblk, 2, C) fp32.
template <typename T, int V>
__global__ void __launch_bounds__(STATS_THREADS)
stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part, long long M, int C,
                     long long rows_per_block) {
    __shared__ float sh[STATS_THREADS * 2 * V];
    const int tx = threadIdx.x, ty = threadIdx.y, CTV = blockDim.x, RY = blockDim.y;
    const int cv = blockIdx.x * CTV + tx;  // vector column
    const long long m0 = (long long)blockIdx.y * rows_per_block;
    const long long m1 = min(m0 + rows_per_block, M);
    float s1[V], s2[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
    if (cv * V < C) {
        const T* xc = x + (long long)blockIdx.z * M * C + cv * V;
        long long m = m0 + ty;
        for (; m + (STATS_UNROLL - 1) * RY < m1; m += STATS_UNROLL * RY) {
            float f[STATS_UNROLL][V];
#pragma unroll
            for (int u = 0; u < STATS_UNROLL; ++u) load_row<T, V>(xc + (m + u * RY) * C, f[u]);
#pragma unroll
            for (int u = 0; u < STATS_UNROLL; ++u)
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    s1[e] += f[u][e];
                    s2[e] = fmaf(f[u][e], f[u][e], s2[e]);
                }
        }
        for (; m < m1; m += RY) {
            float f[V];
            load_row<T, V>(xc + m * C, f);
#pragma unroll
            for (int e = 0; e < V; ++e) {
                s1[e] += f[e];
                s2[e] = fmaf(f[e], f[e], s2[e]);
            }
        }
    }
    // sh[ty][tx][k]: k < V the sums of x, k >= V the sums of x^2
    float* mine = sh + (ty * CTV + tx) * 2 * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
        mine[e] = s1[e];
        mine[V + e] = s2[e];
    }
    __syncthreads();
    const int per_lane = CTV * 2 * V, tid = ty * CTV + tx;
    for (int i = tid; i < per_lane; i += CTV * RY) {
        float acc = 0.f;
        for (int r = 0; r < RY; ++r) acc += sh[r * per_lane + i];
        const int lx = i / (2 * V), k = i - lx * 2 * V;
        const int c = (blockIdx.x * CTV + lx) * V + (k < V ? k : k - V);
        if (c < C)
            part[((long long)blockIdx.z * gridDim.y + blockIdx.y) * 2 * C + (k < V ? 0 : C) + c] =
                acc;
    }
}

// Sums each channel's partials in slab order and folds its group. grid (G,
// B), FOLD_THREADS threads: block (gi, z) owns the Cg = C / G channels of
// group gi in batch z. Its 2 * Cg columns ([sum x | sum x^2] of each
// channel) are summed by FOLD_THREADS / columns lanes over the slabs (one
// lane when the columns fill the block), then in lane order; warp 0 then
// sums the group in a fixed shuffle tree and writes A and b. The launch is a
// few KB of work and runs at latency, so warp 0 loads the scale and shift of
// its first 32 channels before the column sums, not after them. stats: (B,
// 2, C) out; w, bias: (C); A, bb: (B, C) out. Dynamic shared memory: 2 * Cg
// floats.
__global__ void __launch_bounds__(FOLD_THREADS)
stats_reduce_fold_kernel(const float* __restrict__ part, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ stats,
                         float* __restrict__ A, float* __restrict__ bb, int C, int G, int nblk,
                         float cnt, float eps) {
    extern __shared__ float t[];  // [sum x (Cg) | sum x^2 (Cg)] of the group's channels
    __shared__ float red[FOLD_THREADS];
    const int Cg = C / G, c0 = blockIdx.x * Cg, z = blockIdx.y, tid = threadIdx.x;
    const int ncol = 2 * Cg;
    const int lanes = ncol >= FOLD_THREADS ? 1 : FOLD_THREADS / ncol;
    const float* pz = part + (long long)z * nblk * 2 * C;
    const bool pre = tid < 32 && tid < Cg;
    const float w0 = pre ? w[c0 + tid] : 0.f, b0 = pre ? bias[c0 + tid] : 0.f;
    // sum over the slabs i = l0, l0 + step, ... of column col, in order
    auto column = [&](int col, int l0, int step) {
        const float* p = pz + (col < Cg ? c0 + col : C + c0 + col - Cg);
        float s = 0.f;
#pragma unroll 8
        for (int i = l0; i < nblk; i += step) s += p[(long long)i * 2 * C];
        return s;
    };
    if (lanes == 1) {
        for (int col = tid; col < ncol; col += FOLD_THREADS) t[col] = column(col, 0, 1);
    } else {
        const int col = tid % ncol, l = tid / ncol;
        if (l < lanes) red[tid] = column(col, l, lanes);
        __syncthreads();
        if (tid < ncol) {
            float s = 0.f;
            for (int r = 0; r < lanes; ++r) s += red[r * ncol + tid];
            t[tid] = s;
        }
    }
    __syncthreads();
    float* sz = stats + (long long)z * 2 * C + c0;
    for (int j = tid; j < Cg; j += FOLD_THREADS) {
        sz[j] = t[j];
        sz[C + j] = t[Cg + j];
    }
    if (tid < 32) {
        float a = 0.f, q = 0.f;
        for (int j = tid; j < Cg; j += 32) {
            a += t[j];
            q += t[Cg + j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, o);
            q += __shfl_xor_sync(0xffffffffu, q, o);
        }
        const float m = a / cnt;
        const float r = rsqrtf(fmaxf(q / cnt - m * m, 0.f) + eps);
        for (int j = tid; j < Cg; j += 32) {  // j = tid first: the prefetched pair
            const float s = r * (j < 32 ? w0 : w[c0 + j]);
            A[(long long)z * C + c0 + j] = s;
            bb[(long long)z * C + c0 + j] = (j < 32 ? b0 : bias[c0 + j]) - m * s;
        }
    }
}

template <typename T, bool SILU>
__device__ __forceinline__ T affine_one(T xv, float a, float b) {
    float y = to_f(xv) * a + b;
    if (SILU) y = y / (1.f + expf(-y));
    return from_f<T>(y);
}

// Scalar path: one element per thread step.
template <typename T, bool SILU>
__global__ void affine_kernel(const T* __restrict__ x, const float* __restrict__ A,
                              const float* __restrict__ bb, T* __restrict__ y, long long M,
                              int C, long long total) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const long long row = i / C;
        const int c = (int)(i - row * C);
        const long long ac = (row / M) * C + c;
        y[i] = affine_one<T, SILU>(x[i], A[ac], bb[ac]);
    }
}

// Vector path: 16 bytes per thread step; C is a multiple of the vector width,
// so a vector never straddles two rows.
template <typename T, bool SILU>
__global__ void affine_vec_kernel(const T* __restrict__ x, const float* __restrict__ A,
                                  const float* __restrict__ bb, T* __restrict__ y, long long M,
                                  int C, long long total) {
    constexpr int V = 16 / sizeof(T);
    const long long nvec = total / V;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nvec; j += stride) {
        const long long i = j * V;
        const long long row = i / C;
        const int c = (int)(i - row * C);
        const long long ac = (row / M) * C + c;
        uint4 raw = *reinterpret_cast<const uint4*>(x + i);
        const T* e = reinterpret_cast<const T*>(&raw);
        uint4 res;
        T* r = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int t = 0; t < V; ++t) r[t] = affine_one<T, SILU>(e[t], A[ac + t], bb[ac + t]);
        *reinterpret_cast<uint4*>(y + i) = res;
    }
}

template <typename T, int V>
int stats_fold(const void* x, const float* w, const float* bias, float* part, float* stats,
               float* A, float* b, int B, long long M, int C, int G, float eps,
               long long rows_per_block, int nblk, cudaStream_t st) {
    const int cols = C / V;  // vector columns
    const int CTV = cols < 32 ? cols : 32;
    const dim3 block(CTV, STATS_THREADS / CTV);
    const dim3 grid((cols + CTV - 1) / CTV, nblk, B);
    stats_partial_kernel<T, V><<<grid, block, 0, st>>>(static_cast<const T*>(x), part, M, C,
                                                       rows_per_block);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int Cg = C / G;
    const float cnt = (float)((double)M * Cg);
    stats_reduce_fold_kernel<<<dim3(G, B), FOLD_THREADS, 2 * Cg * sizeof(float), st>>>(
        part, w, bias, stats, A, b, C, G, nblk, cnt, eps);
    return (int)cudaGetLastError();
}

template <typename T, bool SILU>
int affine(const void* x, const float* A, const float* b, void* y, int B, long long M, int C,
           int vec, cudaStream_t st) {
    const long long total = (long long)B * M * C;
    const int threads = 256;
    const long long work = vec ? total / (16 / sizeof(T)) : total;
    const long long want = (work + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
    if (vec)
        affine_vec_kernel<T, SILU><<<blocks, threads, 0, st>>>(
            static_cast<const T*>(x), A, b, static_cast<T*>(y), M, C, total);
    else
        affine_kernel<T, SILU><<<blocks, threads, 0, st>>>(
            static_cast<const T*>(x), A, b, static_cast<T*>(y), M, C, total);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous (B, M, C), dtype 0 = f32, 1 = bf16; w, bias: fp32 (C)
// GroupNorm scale and shift, C a multiple of G. partials: fp32 scratch of
// B*nblk*2*C floats; block i of a batch reduces rows [i*rows_per_block,
// min((i+1)*rows_per_block, M)), so nblk = ceil(M / rows_per_block).
// Outputs, fp32: stats (B, 2, C) holding [sum x, sum x^2] per channel; A, b
// (B, C), the folded affine. vec != 0: 16-byte loads, which need a 16-byte
// aligned x and C a multiple of 16 bytes' worth of elements. Returns the
// cudaError_t code.
int medimgen_gn_stats_fold(const void* x, const float* w, const float* bias, float* partials,
                           float* stats, float* A, float* b, int B, long long M, int C, int G,
                           float eps, int dtype, long long rows_per_block, int nblk, int vec,
                           void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int isz = dtype == 1 ? 2 : 4;
    if (B < 1 || M < 1 || G < 1 || C % G != 0 || C / G > MAX_GROUP_CHANNELS || nblk < 1 ||
        rows_per_block < 1 || (long long)(nblk - 1) * rows_per_block >= M ||
        (long long)nblk * rows_per_block < M || (dtype != 0 && dtype != 1) ||
        (vec && (C % (16 / isz) != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
        return (int)cudaErrorInvalidValue;
    if (dtype == 1)
        return vec ? stats_fold<bf16, 8>(x, w, bias, partials, stats, A, b, B, M, C, G, eps,
                                         rows_per_block, nblk, st)
                   : stats_fold<bf16, 1>(x, w, bias, partials, stats, A, b, B, M, C, G, eps,
                                         rows_per_block, nblk, st);
    return vec ? stats_fold<float, 4>(x, w, bias, partials, stats, A, b, B, M, C, G, eps,
                                      rows_per_block, nblk, st)
               : stats_fold<float, 1>(x, w, bias, partials, stats, A, b, B, M, C, G, eps,
                                      rows_per_block, nblk, st);
}

// x, y: contiguous (B, M, C) of the same dtype; A, b: fp32 (B, C).
// vec != 0: x and y are 16-byte aligned and C is a multiple of 16 bytes'
// worth of elements.
int medimgen_gn_affine_act(const void* x, const float* A, const float* b, void* y, int B,
                           long long M, int C, int dtype, int silu, int vec, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return silu ? affine<bf16, true>(x, A, b, y, B, M, C, vec, st)
                    : affine<bf16, false>(x, A, b, y, B, M, C, vec, st);
    if (dtype == 0)
        return silu ? affine<float, true>(x, A, b, y, B, M, C, vec, st)
                    : affine<float, false>(x, A, b, y, B, M, C, vec, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
