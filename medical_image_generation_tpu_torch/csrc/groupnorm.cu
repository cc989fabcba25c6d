// GroupNorm passes for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels in medical_image_generation_tpu/ops/pallas_groupnorm.py:
//   * channel stats: `_stats_kernel` / `lane_stats` (:94-124) and
//     `_stats_any_kernel` / `lane_stats_any` (:127-184). The two TPU kernels
//     compute the same function and differ only in TPU memory placement, so
//     one kernel here serves both.
//   * affine + activation: `_affine_kernel` / `affine_act` (:187-223).
//   * the group fold between them, `_fold_affine` (:226-241). In JAX it is
//     plain array code that XLA fuses; in eager PyTorch it would be ~11 small
//     launches per GroupNorm, and the host's launch rate is what bounds the
//     U-Net forward, so it is one small kernel here.
//
// Both operate on a (B, M, C) activation, which is how a channels-last NCDHW
// tensor lies in memory (M = Z*Y*X), for any M and any C.
//
// channel stats: per (batch, channel) fp32 [sum x, sum x^2] over M. The
//   activation is read once; each block reduces a slab of rows for a tile of
//   channels and writes one fp32 partial, and a second small kernel sums the
//   partials in a fixed order. No float atomics, so repeated runs give
//   bit-identical statistics (and samples).
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

// grid (ceil(C / 32), B); block (32, 8). out: (B, 2, C) fp32.
__global__ void __launch_bounds__(STATS_THREADS)
stats_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int C, int nblk) {
    __shared__ float sh1[STATS_THREADS], sh2[STATS_THREADS];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.x * 32 + tx, z = blockIdx.y;
    float s1 = 0.f, s2 = 0.f;
    if (c < C) {
        for (int i = ty; i < nblk; i += 8) {
            const float* p = part + ((long long)z * nblk + i) * 2 * C;
            s1 += p[c];
            s2 += p[C + c];
        }
    }
    sh1[ty * 32 + tx] = s1;
    sh2[ty * 32 + tx] = s2;
    __syncthreads();
    if (ty == 0 && c < C) {
        for (int j = 1; j < 8; ++j) {
            s1 += sh1[j * 32 + tx];
            s2 += sh2[j * 32 + tx];
        }
        out[(long long)z * 2 * C + c] = s1;
        out[(long long)z * 2 * C + C + c] = s2;
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

// grid (B); block 256; dynamic shared memory (2*C + 2*G) floats.
// stats: (B, 2, C) sums; A, bb: (B, C) fp32.
__global__ void fold_kernel(const float* __restrict__ stats, const float* __restrict__ w,
                            const float* __restrict__ bias, float* __restrict__ A,
                            float* __restrict__ bb, int C, int G, float cnt, float eps) {
    extern __shared__ float sh[];
    float* s1 = sh;
    float* s2 = sh + C;
    float* mean = sh + 2 * C;
    float* rinv = mean + G;
    const int z = blockIdx.x, Cg = C / G;
    const float* st = stats + (long long)z * 2 * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) { s1[c] = st[c]; s2[c] = st[C + c]; }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
        float a = 0.f, q = 0.f;
        for (int j = 0; j < Cg; ++j) { a += s1[g * Cg + j]; q += s2[g * Cg + j]; }
        const float m = a / cnt;
        const float var = fmaxf(q / cnt - m * m, 0.f);
        mean[g] = m;
        rinv[g] = rsqrtf(var + eps);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const int g = c / Cg;
        const float a = rinv[g] * w[c];
        A[(long long)z * C + c] = a;
        bb[(long long)z * C + c] = bias[c] - mean[g] * a;
    }
}

template <typename T, int V>
int stats(const void* x, float* part, float* out, int B, long long M, int C,
          long long rows_per_block, int nblk, cudaStream_t st) {
    const int cols = C / V;  // vector columns
    const int CTV = cols < 32 ? cols : 32;
    const dim3 block(CTV, STATS_THREADS / CTV);
    const dim3 grid((cols + CTV - 1) / CTV, nblk, B);
    stats_partial_kernel<T, V><<<grid, block, 0, st>>>(static_cast<const T*>(x), part, M, C,
                                                       rows_per_block);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    stats_reduce_kernel<<<dim3((C + 31) / 32, B), dim3(32, 8), 0, st>>>(part, out, C, nblk);
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

// x: contiguous (B, M, C), dtype 0 = f32, 1 = bf16. partials: fp32 scratch of
// B*nblk*2*C floats; block i of a batch reduces rows [i*rows_per_block,
// min((i+1)*rows_per_block, M)), so nblk = ceil(M / rows_per_block). out: fp32
// (B, 2, C) holding [sum x, sum x^2]. vec != 0: 16-byte loads, which need a
// 16-byte aligned x and C a multiple of 16 bytes' worth of elements.
// Returns the cudaError_t code.
int medimgen_gn_channel_stats(const void* x, float* partials, float* out, int B, long long M,
                              int C, int dtype, long long rows_per_block, int nblk, int vec,
                              void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int isz = dtype == 1 ? 2 : 4;
    if (nblk < 1 || rows_per_block < 1 || (dtype != 0 && dtype != 1) ||
        (vec && (C % (16 / isz) != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
        return (int)cudaErrorInvalidValue;
    if (dtype == 1)
        return vec ? stats<bf16, 8>(x, partials, out, B, M, C, rows_per_block, nblk, st)
                   : stats<bf16, 1>(x, partials, out, B, M, C, rows_per_block, nblk, st);
    return vec ? stats<float, 4>(x, partials, out, B, M, C, rows_per_block, nblk, st)
               : stats<float, 1>(x, partials, out, B, M, C, rows_per_block, nblk, st);
}

// stats: fp32 (B, 2, C) channel sums over n_spatial rows; w, bias: fp32 (C);
// A, b: fp32 (B, C) outputs. C must be a multiple of G.
int medimgen_gn_fold(const float* stats, const float* w, const float* bias, float* A, float* b,
                     int B, int C, int G, long long n_spatial, float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = sizeof(float) * (2 * (size_t)C + 2 * (size_t)G);
    if (G < 1 || C % G != 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const float cnt = (float)((double)n_spatial * (C / G));
    fold_kernel<<<B, 256, smem, st>>>(stats, w, bias, A, b, C, G, cnt, eps);
    return (int)cudaGetLastError();
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
