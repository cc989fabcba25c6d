// GroupNorm(+SiLU) backward for Hopper (sm_90a), plain C interface for ctypes.
//
// The JAX package has no Pallas kernel here: the U-Net's GroupNorm
// (medical_image_generation_tpu/models/blocks.py:105-184) is differentiated
// by XLA, which fuses the gradient, and the closed form it keeps beside the
// Pallas forward is plain JAX (`_gn_vjp_bwd`, ops/pallas_groupnorm.py:372-471).
// In eager PyTorch that closed form is ~12 launches per GroupNorm, ~550 per
// U-Net backward, and eager glue already made the forward host-bound, so it
// is two kernel passes here, on the same (B, M, C) channels-last buffer as
// the forward kernels (groupnorm.cu):
//
//   gn_bwd_stats: z = x*A + b, gz = g * silu'(z) (or g), then per channel
//     t1 = sum_m gz and t2 = sum_m gz*x in fp32: per-slab partials and a
//     fixed-order second pass, no atomics, so the gradient is bit-identical
//     from run to run. A third, one-block launch folds the sums at (B, C)
//     size: per (batch, group), with u2 = t2 - mean*t1,
//       S1 = sum_c t1*w,  S2h = rinv * sum_c u2*w,
//       P = -rinv^2 S2h / n,  Q = (-rinv S1 + mean rinv^2 S2h) / n,
//     and dscale = sum_b u2*rinv, dbias = sum_b t1 (in batch order).
//     Bound: bytes, two reads of the activation (x and g).
//   gn_bwd_apply: dx = gz*A + x*P + Q, fp32 math, one rounding at the store.
//     Bound: bytes, two reads and one write of the activation.
//
// Simple first, as the forward stats kernel: one element per thread per row
// in the reduction; 16-byte vector accesses in the apply when C allows.

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

constexpr int THREADS = 256;

// effective cotangent of the affine output: g * d silu(z)/dz, or g
template <bool SILU>
__device__ __forceinline__ float grad_z(float gv, float xv, float a, float b) {
    if (!SILU) return gv;
    const float z = xv * a + b;
    const float sig = 1.f / (1.f + expf(-z));
    return gv * sig * (1.f + z * (1.f - sig));
}

// grid (ceil(C / blockDim.x), nblk, B); block (CT, 256 / CT).
// partials: (B, nblk, 2, C) fp32 holding [sum gz, sum gz*x] of each slab.
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ A,
                   const float* __restrict__ bb, float* __restrict__ part, long long M, int C,
                   long long rows_per_block) {
    __shared__ float sh1[THREADS], sh2[THREADS];
    const int tx = threadIdx.x, ty = threadIdx.y, CT = blockDim.x, RY = blockDim.y;
    const int c = blockIdx.x * CT + tx, z = blockIdx.z;
    const long long m0 = (long long)blockIdx.y * rows_per_block;
    const long long m1 = min(m0 + rows_per_block, M);
    const long long base = (long long)z * M * C;
    float s1 = 0.f, s2 = 0.f;
    if (c < C) {
        const float a = A[(long long)z * C + c], b = bb[(long long)z * C + c];
        for (long long m = m0 + ty; m < m1; m += RY) {
            const float xv = to_f(x[base + m * C + c]);
            const float gz = grad_z<SILU>(to_f(g[base + m * C + c]), xv, a, b);
            s1 += gz;
            s2 += gz * xv;
        }
    }
    sh1[ty * CT + tx] = s1;
    sh2[ty * CT + tx] = s2;
    __syncthreads();
    if (ty == 0 && c < C) {
        for (int j = 1; j < RY; ++j) {
            s1 += sh1[j * CT + tx];
            s2 += sh2[j * CT + tx];
        }
        float* p = part + ((long long)z * gridDim.y + blockIdx.y) * 2 * C;
        p[c] = s1;
        p[C + c] = s2;
    }
}

// grid (ceil(C / 32), B); block (32, 8). t: (B, 2, C) fp32.
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ t, int C, int nblk) {
    __shared__ float sh1[THREADS], sh2[THREADS];
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
        t[(long long)z * 2 * C + c] = s1;
        t[(long long)z * 2 * C + C + c] = s2;
    }
}

// One block. stats: forward channel sums (B, 2, C); t: (B, 2, C) from above;
// coef: (B, 2, C) out [P, Q] per channel; dscale, dbias: (C) out.
// Dynamic shared memory: 4*G floats.
__global__ void __launch_bounds__(THREADS)
bwd_fold_kernel(const float* __restrict__ stats, const float* __restrict__ t,
                const float* __restrict__ w, float* __restrict__ coef,
                float* __restrict__ dscale, float* __restrict__ dbias, int B, int C, int G,
                float cnt, float eps) {
    extern __shared__ float sh[];
    float* mean = sh;
    float* rinv = sh + G;
    float* P = sh + 2 * G;
    float* Q = sh + 3 * G;
    const int Cg = C / G;
    for (int z = 0; z < B; ++z) {
        const float* st = stats + (long long)z * 2 * C;
        const float* tz = t + (long long)z * 2 * C;
        for (int gi = threadIdx.x; gi < G; gi += blockDim.x) {
            float a = 0.f, q = 0.f;
            for (int j = 0; j < Cg; ++j) { a += st[gi * Cg + j]; q += st[C + gi * Cg + j]; }
            const float m = a / cnt;
            const float r = rsqrtf(fmaxf(q / cnt - m * m, 0.f) + eps);
            float S1 = 0.f, S2 = 0.f;
            for (int j = 0; j < Cg; ++j) {
                const int c = gi * Cg + j;
                S1 += tz[c] * w[c];
                S2 += (tz[C + c] - m * tz[c]) * w[c];
            }
            const float S2h = S2 * r;
            mean[gi] = m;
            rinv[gi] = r;
            P[gi] = -(r * r) * S2h / cnt;
            Q[gi] = (-r * S1 + m * (r * r) * S2h) / cnt;
        }
        __syncthreads();
        for (int c = threadIdx.x; c < C; c += blockDim.x) {
            const int gi = c / Cg;
            const float u2 = tz[C + c] - mean[gi] * tz[c];
            coef[(long long)z * 2 * C + c] = P[gi];
            coef[(long long)z * 2 * C + C + c] = Q[gi];
            const float ds = u2 * rinv[gi], db = tz[c];
            dscale[c] = z == 0 ? ds : dscale[c] + ds;  // batch order: deterministic
            dbias[c] = z == 0 ? db : dbias[c] + db;
        }
        __syncthreads();
    }
}

template <typename T, bool SILU>
__device__ __forceinline__ T apply_one(T xv, T gv, float a, float b, float p, float q) {
    const float xf = to_f(xv);
    return from_f<T>(grad_z<SILU>(to_f(gv), xf, a, b) * a + xf * p + q);
}

// Scalar path: one element per thread step. coef: (B, 2, C) [P, Q].
template <typename T, bool SILU>
__global__ void apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             const float* __restrict__ A, const float* __restrict__ bb,
                             const float* __restrict__ coef, T* __restrict__ dx, long long M,
                             int C, long long total) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
        const long long row = i / C;
        const int c = (int)(i - row * C);
        const long long z = row / M, ac = z * C + c, pc = z * 2 * C + c;
        dx[i] = apply_one<T, SILU>(x[i], g[i], A[ac], bb[ac], coef[pc], coef[pc + C]);
    }
}

// Vector path: 16 bytes per thread step; C is a multiple of the vector width.
template <typename T, bool SILU>
__global__ void apply_vec_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                 const float* __restrict__ A, const float* __restrict__ bb,
                                 const float* __restrict__ coef, T* __restrict__ dx, long long M,
                                 int C, long long total) {
    constexpr int V = 16 / sizeof(T);
    const long long nvec = total / V;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < nvec; j += stride) {
        const long long i = j * V;
        const long long row = i / C;
        const int c = (int)(i - row * C);
        const long long z = row / M, ac = z * C + c, pc = z * 2 * C + c;
        uint4 rx = *reinterpret_cast<const uint4*>(x + i);
        uint4 rg = *reinterpret_cast<const uint4*>(g + i);
        const T* ex = reinterpret_cast<const T*>(&rx);
        const T* eg = reinterpret_cast<const T*>(&rg);
        uint4 res;
        T* r = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int e = 0; e < V; ++e)
            r[e] = apply_one<T, SILU>(ex[e], eg[e], A[ac + e], bb[ac + e], coef[pc + e],
                                      coef[pc + C + e]);
        *reinterpret_cast<uint4*>(dx + i) = res;
    }
}

template <typename T, bool SILU>
int bwd_stats(const void* x, const void* g, const float* A, const float* bb,
              const float* stats, const float* w, float* part, float* t, float* coef,
              float* dscale, float* dbias, int B, long long M, int C, int G, float eps,
              long long rows_per_block, int nblk, cudaStream_t st) {
    const int CT = C >= 64 ? 64 : 32;
    const dim3 block(CT, THREADS / CT);
    const dim3 grid((C + CT - 1) / CT, nblk, B);
    bwd_partial_kernel<T, SILU><<<grid, block, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), A, bb, part, M, C, rows_per_block);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bwd_reduce_kernel<<<dim3((C + 31) / 32, B), dim3(32, 8), 0, st>>>(part, t, C, nblk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const float cnt = (float)((double)M * (C / G));
    bwd_fold_kernel<<<1, THREADS, 4 * G * sizeof(float), st>>>(stats, t, w, coef, dscale,
                                                               dbias, B, C, G, cnt, eps);
    return (int)cudaGetLastError();
}

template <typename T, bool SILU>
int bwd_apply(const void* x, const void* g, const float* A, const float* bb, const float* coef,
              void* dx, int B, long long M, int C, int vec, cudaStream_t st) {
    const long long total = (long long)B * M * C;
    const int threads = 256;
    const long long work = vec ? total / (16 / sizeof(T)) : total;
    const long long want = (work + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
    if (vec)
        apply_vec_kernel<T, SILU><<<blocks, threads, 0, st>>>(
            static_cast<const T*>(x), static_cast<const T*>(g), A, bb, coef,
            static_cast<T*>(dx), M, C, total);
    else
        apply_kernel<T, SILU><<<blocks, threads, 0, st>>>(
            static_cast<const T*>(x), static_cast<const T*>(g), A, bb, coef,
            static_cast<T*>(dx), M, C, total);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, g: contiguous (B, M, C) of one dtype (0 = f32, 1 = bf16); A, b: the
// forward's folded affine, fp32 (B, C); stats: the forward's channel sums,
// fp32 (B, 2, C); w: fp32 (C) GroupNorm scale. partials: fp32 scratch of
// B*nblk*2*C floats, nblk = ceil(M / rows_per_block); t: fp32 (B, 2, C)
// scratch. Outputs: coef fp32 (B, 2, C) [P, Q], dscale and dbias fp32 (C).
// Returns the cudaError_t code.
int medimgen_gn_bwd_stats(const void* x, const void* g, const float* A, const float* b,
                          const float* stats, const float* w, float* partials, float* t,
                          float* coef, float* dscale, float* dbias, int B, long long M, int C,
                          int G, float eps, int dtype, int silu, long long rows_per_block,
                          int nblk, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (G < 1 || C % G != 0 || B < 1) return (int)cudaErrorInvalidValue;
#define MEDIMGEN_ARGS x, g, A, b, stats, w, partials, t, coef, dscale, dbias, B, M, C, G, eps, \
                      rows_per_block, nblk, st
    if (dtype == 1)
        return silu ? bwd_stats<bf16, true>(MEDIMGEN_ARGS) : bwd_stats<bf16, false>(MEDIMGEN_ARGS);
    if (dtype == 0)
        return silu ? bwd_stats<float, true>(MEDIMGEN_ARGS)
                    : bwd_stats<float, false>(MEDIMGEN_ARGS);
#undef MEDIMGEN_ARGS
    return (int)cudaErrorInvalidValue;
}

// x, g, dx: contiguous (B, M, C) of one dtype; A, b: fp32 (B, C); coef: fp32
// (B, 2, C) from medimgen_gn_bwd_stats. vec != 0: x, g and dx are 16-byte
// aligned and C is a multiple of 16 bytes' worth of elements.
int medimgen_gn_bwd_apply(const void* x, const void* g, const float* A, const float* b,
                          const float* coef, void* dx, int B, long long M, int C, int dtype,
                          int silu, int vec, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1)
        return silu ? bwd_apply<bf16, true>(x, g, A, b, coef, dx, B, M, C, vec, st)
                    : bwd_apply<bf16, false>(x, g, A, b, coef, dx, B, M, C, vec, st);
    if (dtype == 0)
        return silu ? bwd_apply<float, true>(x, g, A, b, coef, dx, B, M, C, vec, st)
                    : bwd_apply<float, false>(x, g, A, b, coef, dx, B, M, C, vec, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
