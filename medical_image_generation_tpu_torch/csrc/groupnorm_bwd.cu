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
//     t1 = sum_m gz and t2 = sum_m gz*x in fp32: per-slab partials, then one
//     launch that sums them in a fixed order and folds them at (B, C) size,
//     one block per group taking the batches in order: with u2 = t2 - mean*t1,
//       S1 = sum_c t1*w,  S2h = rinv * sum_c u2*w,
//       P = -rinv^2 S2h / n,  Q = (-rinv S1 + mean rinv^2 S2h) / n,
//     and dscale = sum_b u2*rinv, dbias = sum_b t1 (in batch order). No
//     float atomics: coef, dscale and dbias are bit-identical run to run.
//     Bound: bytes, two reads of the activation (x and g).
//   gn_bwd_apply: dx = gz*A + x*P + Q, fp32 math, one rounding at the store.
//     Bound: bytes, two reads and one write of the activation.
//
// Both passes stream the activation as the forward channel stats do: a
// thread owns V = 16 / sizeof(T) adjacent channels (8 bf16, 4 f32) where C
// and the base pointers allow it, else one; a warp reads 512 contiguous
// bytes of each tensor (at small C several whole rows). The thread holds its
// channels' A and b (and, in the apply, P and Q) in registers for its whole
// slab, and the row loop does no integer division. The SiLU derivative costs
// about as many instructions as the loads take time, so on the 16-byte path
// the loads go through a per-thread cp.async ring in shared memory (STAGES
// rows in flight while one is computed) instead of registers, which kept
// them in flight only between the arithmetic; the scalar path loads UNROLL
// rows into registers. The caller sizes the grid from the SM count
// (`_bwd_slabs` in ops/groupnorm.py). The SiLU derivative uses the fast
// exponential and division (__expf, __fdividef); the tolerances are the
// precise forms' (chip_smoke.py GN_BWD_TOL, GN_PARAM_GRAD_TOL).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // scalar path: independent row loads of each tensor in flight a thread
constexpr int STAGES = 4;  // 16-byte path: rows of x and g in flight a thread (cp.async ring)
constexpr int RING_BYTES = STAGES * 2 * THREADS * 16;
constexpr int FOLD_THREADS = 512;
constexpr int FOLD_COLS = 2048;  // [t1 | t2] columns of the batches the fold holds at once
constexpr int MAX_GROUP_CHANNELS = 2048;  // the fold's shared memory: ~16 * Cg bytes
static_assert(RING_BYTES >= THREADS * 2 * 8 * sizeof(float), "the ring holds the block's sums");

// V channels of one row as loaded: 16 bytes, or one element when V = 1.
template <typename T, int V>
using raw_t = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ raw_t<T, V> load(const T* p) {
    return *reinterpret_cast<const raw_t<T, V>*>(p);
}
template <typename T, int V>
__device__ __forceinline__ float elem(const raw_t<T, V>& r, int e) {
    if constexpr (V == 1) return to_f(r);
    else return to_f(reinterpret_cast<const T*>(&r)[e]);
}

// cp.async: 16 bytes from global to shared memory through L2 only
__device__ __forceinline__ void copy16(uint4* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Calls row(x row, g row, m) for the rows m = first, first + RY, ... < m1 of
// the thread's V channels, in order; xc and gc point at row 0 of them.
// 16-byte path: a ring of STAGES rows of x and g a thread in shared memory
// (`ring`, RING_BYTES), filled by cp.async so that STAGES - 1 rows stay in
// flight while one is computed; each thread reads only the slots it filled,
// so there is no barrier. Scalar path: UNROLL rows at a time in registers.
template <typename T, int V, typename F>
__device__ __forceinline__ void stream_rows(const T* xc, const T* gc, long long first,
                                            long long m1, int RY, int C, uint4* ring, int tid,
                                            F&& row) {
    if constexpr (V > 1) {
        long long mi = first;  // next row to issue
#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s, mi += RY) {
            if (mi < m1) {
                copy16(&ring[(2 * s) * THREADS + tid], xc + mi * C);
                copy16(&ring[(2 * s + 1) * THREADS + tid], gc + mi * C);
            }
            copy_commit();
        }
        int su = 0, si = STAGES - 1;  // stage to use, stage to issue
        for (long long m = first; m < m1; m += RY, mi += RY) {
            if (mi < m1) {
                copy16(&ring[(2 * si) * THREADS + tid], xc + mi * C);
                copy16(&ring[(2 * si + 1) * THREADS + tid], gc + mi * C);
            }
            copy_commit();
            copy_wait<STAGES - 1>();
            row(ring[(2 * su) * THREADS + tid], ring[(2 * su + 1) * THREADS + tid], m);
            su = su + 1 == STAGES ? 0 : su + 1;
            si = si + 1 == STAGES ? 0 : si + 1;
        }
        copy_wait<0>();
    } else {
        long long m = first;
        for (; m + (UNROLL - 1) * RY < m1; m += UNROLL * RY) {
            T rx[UNROLL], rg[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                rx[u] = xc[(m + u * RY) * C];
                rg[u] = gc[(m + u * RY) * C];
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) row(rx[u], rg[u], m + u * RY);
        }
        for (; m < m1; m += RY) row(xc[m * C], gc[m * C], m);
    }
}

// effective cotangent of the affine output: g * d silu(z)/dz, or g
template <bool SILU>
__device__ __forceinline__ float grad_z(float gv, float xv, float a, float b) {
    if (!SILU) return gv;
    const float z = fmaf(xv, a, b);
    const float sig = __fdividef(1.f, 1.f + __expf(-z));
    return gv * sig * (1.f + z * (1.f - sig));
}

// Partial [sum gz, sum gz*x] of V adjacent channels over a slab of rows.
// grid (ceil(C / (V * CTV)), nblk, B); block (CTV, RY): thread (tx, ty) owns
// channels [(blockIdx.x * CTV + tx) * V, +V) and rows m0 + ty, m0 + ty + RY,
// ... of its block's slab; the block then sums its RY row lanes in order.
// partials: (B, nblk, 2, C) fp32. Dynamic shared memory: the ring (16-byte
// path), then the block's sums, THREADS * 2 * V floats.
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ A, const float* __restrict__ bb,
                      float* __restrict__ part, long long M, int C, long long rows_per_block) {
    extern __shared__ uint4 ring[];
    const int tx = threadIdx.x, ty = threadIdx.y, CTV = blockDim.x, RY = blockDim.y;
    const int cv = blockIdx.x * CTV + tx, z = blockIdx.z, tid = ty * CTV + tx;
    const long long m0 = (long long)blockIdx.y * rows_per_block;
    const long long m1 = min(m0 + rows_per_block, M);
    float s1[V], s2[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s1[e] = s2[e] = 0.f;
    if (cv * V < C) {
        float a[V], b[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
            a[e] = A[(long long)z * C + cv * V + e];
            b[e] = bb[(long long)z * C + cv * V + e];
        }
        const long long off = (long long)z * M * C + cv * V;
        stream_rows<T, V>(x + off, g + off, m0 + ty, m1, RY, C, ring, tid,
                          [&](const raw_t<T, V>& rx, const raw_t<T, V>& rg, long long) {
#pragma unroll
                              for (int e = 0; e < V; ++e) {
                                  const float xv = elem<T, V>(rx, e);
                                  const float gz =
                                      grad_z<SILU>(elem<T, V>(rg, e), xv, a[e], b[e]);
                                  s1[e] += gz;
                                  s2[e] = fmaf(gz, xv, s2[e]);
                              }
                          });
    }
    __syncthreads();  // the ring's memory now holds the block's sums
    // sh[ty][tx][k]: k < V the sums of gz, k >= V the sums of gz*x
    float* sh = reinterpret_cast<float*>(ring);
    float* mine = sh + tid * 2 * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
        mine[e] = s1[e];
        mine[V + e] = s2[e];
    }
    __syncthreads();
    const int per_lane = CTV * 2 * V;
    for (int i = tid; i < per_lane; i += CTV * RY) {
        float acc = 0.f;
        for (int r = 0; r < RY; ++r) acc += sh[r * per_lane + i];
        const int lx = i / (2 * V), k = i - lx * 2 * V;
        const int c = (blockIdx.x * CTV + lx) * V + (k < V ? k : k - V);
        if (c < C)
            part[((long long)z * gridDim.y + blockIdx.y) * 2 * C + (k < V ? 0 : C) + c] = acc;
    }
}

// batches whose [t1 | t2] the fold holds at once: at most FOLD_COLS columns
// (at least one batch) and one warp each
inline int fold_batches(int B, int Cg) {
    int bc = FOLD_COLS / (2 * Cg);
    bc = bc < 1 ? 1 : (bc > FOLD_THREADS / 32 ? FOLD_THREADS / 32 : bc);
    return bc < B ? bc : B;
}

// Sums each (batch, channel)'s partials in slab order and folds them. grid
// (G), FOLD_THREADS threads: block gi owns the Cg = C / G channels of group
// gi and takes the batches Bc at a time, in order. The chunk's nb * 2 * Cg
// columns ([t1 | t2] of each batch and channel) are summed by FOLD_THREADS /
// columns lanes over the slabs (one lane when the columns fill the block),
// then in lane order; warp w folds batch z0 + w. stats: the forward's channel
// sums (B, 2, C); coef: (B, 2, C) out [P, Q] per channel; dscale, dbias: (C)
// out, summed over the batches in order. Dynamic shared memory: (Bc * 2 * Cg
// + 2 * Cg + 4 * Bc) floats.
__global__ void __launch_bounds__(FOLD_THREADS)
gn_bwd_reduce_fold_kernel(const float* __restrict__ part, const float* __restrict__ stats,
                          const float* __restrict__ w, float* __restrict__ coef,
                          float* __restrict__ dscale, float* __restrict__ dbias, int B, int C,
                          int G, int Bc, int nblk, float cnt, float eps) {
    extern __shared__ float fold_sh[];
    __shared__ float red[FOLD_THREADS];
    const int Cg = C / G, c0 = blockIdx.x * Cg, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, per_b = 2 * Cg;
    float* t = fold_sh;            // [batch of the chunk][t1 (Cg) | t2 (Cg)]
    float* dsa = t + Bc * per_b;   // dscale, summed over the batches so far
    float* dba = dsa + Cg;         // dbias, the same
    float* grp = dba + Cg;         // [batch of the chunk][mean, rinv, P, Q]
    for (int z0 = 0; z0 < B; z0 += Bc) {
        const int nb = min(Bc, B - z0), ncol = nb * per_b;
        const int lanes = ncol >= FOLD_THREADS ? 1 : FOLD_THREADS / ncol;
        // sum over the slabs i = l0, l0 + step, ... of column col, in order
        auto column = [&](int col, int l0, int step) {
            const int wb = col / per_b, r = col - wb * per_b;
            const float* p = part + (long long)(z0 + wb) * nblk * 2 * C +
                             (r < Cg ? c0 + r : C + c0 + r - Cg);
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
        if (warp < nb) {  // warp w: batch z0 + w's group statistics and [P, Q], fixed order
            const float* st = stats + (long long)(z0 + warp) * 2 * C + c0;
            const float* tw = t + warp * per_b;
            float a = 0.f, q = 0.f;
            for (int j = lane; j < Cg; j += 32) { a += st[j]; q += st[C + j]; }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                a += __shfl_xor_sync(0xffffffffu, a, o);
                q += __shfl_xor_sync(0xffffffffu, q, o);
            }
            const float m = a / cnt;
            const float r = rsqrtf(fmaxf(q / cnt - m * m, 0.f) + eps);
            float S1 = 0.f, S2 = 0.f;
            for (int j = lane; j < Cg; j += 32) {
                S1 += tw[j] * w[c0 + j];
                S2 += (tw[Cg + j] - m * tw[j]) * w[c0 + j];
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                S1 += __shfl_xor_sync(0xffffffffu, S1, o);
                S2 += __shfl_xor_sync(0xffffffffu, S2, o);
            }
            if (lane == 0) {
                const float S2h = S2 * r;
                grp[4 * warp] = m;
                grp[4 * warp + 1] = r;
                grp[4 * warp + 2] = -(r * r) * S2h / cnt;
                grp[4 * warp + 3] = (-r * S1 + m * (r * r) * S2h) / cnt;
            }
        }
        __syncthreads();
        for (int i = tid; i < nb * Cg; i += FOLD_THREADS) {
            const int wb = i / Cg, j = i - wb * Cg;
            float* cz = coef + (long long)(z0 + wb) * 2 * C + c0;
            cz[j] = grp[4 * wb + 2];
            cz[C + j] = grp[4 * wb + 3];
        }
        for (int j = tid; j < Cg; j += FOLD_THREADS)
            for (int wb = 0; wb < nb; ++wb) {  // batch order: deterministic
                const float* tw = t + wb * per_b;
                const float ds = (tw[Cg + j] - grp[4 * wb] * tw[j]) * grp[4 * wb + 1];
                const bool first = z0 + wb == 0;
                dsa[j] = first ? ds : dsa[j] + ds;
                dba[j] = first ? tw[j] : dba[j] + tw[j];
            }
        __syncthreads();  // t and grp are rewritten for the next chunk
    }
    for (int j = tid; j < Cg; j += FOLD_THREADS) {
        dscale[c0 + j] = dsa[j];
        dbias[c0 + j] = dba[j];
    }
}

// dx = gz*A + x*P + Q. Same grid, block and row lanes as the partial kernel;
// the thread loads its V channels' A, b, P, Q once, then streams its rows.
// Dynamic shared memory: the ring (16-byte path).
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ A, const float* __restrict__ bb,
                    const float* __restrict__ coef, T* __restrict__ dx, long long M, int C,
                    long long rows_per_block) {
    extern __shared__ uint4 ring[];
    const int tx = threadIdx.x, ty = threadIdx.y, CTV = blockDim.x, RY = blockDim.y;
    const int cv = blockIdx.x * CTV + tx, z = blockIdx.z;
    if (cv * V >= C) return;
    const long long m0 = (long long)blockIdx.y * rows_per_block;
    const long long m1 = min(m0 + rows_per_block, M);
    float a[V], b[V], p[V], q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
        const long long c = (long long)z * C + cv * V + e;
        a[e] = A[c];
        b[e] = bb[c];
        p[e] = coef[c + (long long)z * C];
        q[e] = coef[c + (long long)z * C + C];
    }
    const long long off = (long long)z * M * C + cv * V;
    T* dc = dx + off;
    stream_rows<T, V>(x + off, g + off, m0 + ty, m1, RY, C, ring, ty * CTV + tx,
                      [&](const raw_t<T, V>& rx, const raw_t<T, V>& rg, long long m) {
                          raw_t<T, V> res;
#pragma unroll
                          for (int e = 0; e < V; ++e) {
                              const float xv = elem<T, V>(rx, e);
                              const float gz = grad_z<SILU>(elem<T, V>(rg, e), xv, a[e], b[e]);
                              reinterpret_cast<T*>(&res)[e] =
                                  from_f<T>(fmaf(gz, a[e], fmaf(xv, p[e], q[e])));
                          }
                          *reinterpret_cast<raw_t<T, V>*>(dc + m * C) = res;
                      });
}

// block (CTV, 256 / CTV) and grid (column tiles, nblk, B) of both passes
template <int V>
void geometry(int B, int C, int nblk, dim3& grid, dim3& block) {
    const int cols = (C + V - 1) / V;
    const int CTV = cols < 32 ? cols : 32;
    block = dim3(CTV, THREADS / CTV);
    grid = dim3((cols + CTV - 1) / CTV, nblk, B);
}

struct StatsArgs {
    const void *x, *g;
    const float *A, *b, *stats, *w;
    float *part, *coef, *dscale, *dbias;
    int B;
    long long M;
    int C, G;
    float eps;
    long long rows;
    int nblk;
    cudaStream_t st;
};

template <typename T, int V, bool SILU>
int bwd_stats(const StatsArgs& a) {
    dim3 grid, block;
    geometry<V>(a.B, a.C, a.nblk, grid, block);
    const int sums = THREADS * 2 * V * (int)sizeof(float);
    gn_bwd_partial_kernel<T, V, SILU><<<grid, block, V > 1 ? RING_BYTES : sums, a.st>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.A, a.b, a.part, a.M, a.C,
        a.rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int Cg = a.C / a.G, Bc = fold_batches(a.B, Cg);
    const float cnt = (float)((double)a.M * Cg);
    const size_t smem = sizeof(float) * ((size_t)Bc * 2 * Cg + 2 * Cg + 4 * Bc);
    gn_bwd_reduce_fold_kernel<<<a.G, FOLD_THREADS, smem, a.st>>>(
        a.part, a.stats, a.w, a.coef, a.dscale, a.dbias, a.B, a.C, a.G, Bc, a.nblk, cnt, a.eps);
    return (int)cudaGetLastError();
}

template <typename T, int V>
int bwd_stats_act(const StatsArgs& a, int silu) {
    return silu ? bwd_stats<T, V, true>(a) : bwd_stats<T, V, false>(a);
}

struct ApplyArgs {
    const void *x, *g;
    const float *A, *b, *coef;
    void* dx;
    int B;
    long long M;
    int C;
    long long rows;
    int nblk;
    cudaStream_t st;
};

template <typename T, int V, bool SILU>
int bwd_apply(const ApplyArgs& a) {
    dim3 grid, block;
    geometry<V>(a.B, a.C, a.nblk, grid, block);
    gn_bwd_apply_kernel<T, V, SILU><<<grid, block, V > 1 ? RING_BYTES : 0, a.st>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.g), a.A, a.b, a.coef,
        static_cast<T*>(a.dx), a.M, a.C, a.rows);
    return (int)cudaGetLastError();
}

template <typename T, int V>
int bwd_apply_act(const ApplyArgs& a, int silu) {
    return silu ? bwd_apply<T, V, true>(a) : bwd_apply<T, V, false>(a);
}

// The slabs [i * rows, (i + 1) * rows) for i < nblk cover [0, M), none empty;
// vec: C and every pointer allow 16-byte accesses.
bool valid(int dtype, long long M, int C, long long rows, int nblk, int vec,
           const void* p0, const void* p1, const void* p2) {
    const int isz = dtype == 1 ? 2 : 4;
    if ((dtype != 0 && dtype != 1) || M < 1 || C < 1 || rows < 1 || nblk < 1 ||
        (long long)(nblk - 1) * rows >= M || (long long)nblk * rows < M)
        return false;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1) |
                           reinterpret_cast<uintptr_t>(p2);
    return !vec || (C % (16 / isz) == 0 && bits % 16 == 0);
}

}  // namespace

extern "C" {

// x, g: contiguous (B, M, C) of one dtype (0 = f32, 1 = bf16); A, b: the
// forward's folded affine, fp32 (B, C); stats: the forward's channel sums,
// fp32 (B, 2, C); w: fp32 (C) GroupNorm scale. partials: fp32 scratch of
// B*nblk*2*C floats; slab i of a batch is rows [i*rows_per_block,
// min((i+1)*rows_per_block, M)), so nblk = ceil(M / rows_per_block).
// Outputs: coef fp32 (B, 2, C) [P, Q], dscale and dbias fp32 (C). vec != 0:
// 16-byte loads, which need 16-byte aligned x and g and C a multiple of 16
// bytes' worth of elements. Returns the cudaError_t code.
int medimgen_gn_bwd_stats(const void* x, const void* g, const float* A, const float* b,
                          const float* stats, const float* w, float* partials, float* coef,
                          float* dscale, float* dbias, int B, long long M, int C, int G,
                          float eps, int dtype, int silu, long long rows_per_block, int nblk,
                          int vec, void* stream) {
    if (B < 1 || G < 1 || C % G != 0 || C / G > MAX_GROUP_CHANNELS ||
        !valid(dtype, M, C, rows_per_block, nblk, vec, x, g, x))
        return (int)cudaErrorInvalidValue;
    const StatsArgs a{x, g, A, b, stats, w, partials, coef, dscale, dbias, B, M, C, G, eps,
                      rows_per_block, nblk, static_cast<cudaStream_t>(stream)};
    if (dtype == 1) return vec ? bwd_stats_act<bf16, 8>(a, silu) : bwd_stats_act<bf16, 1>(a, silu);
    return vec ? bwd_stats_act<float, 4>(a, silu) : bwd_stats_act<float, 1>(a, silu);
}

// x, g, dx: contiguous (B, M, C) of one dtype; A, b: fp32 (B, C); coef: fp32
// (B, 2, C) from medimgen_gn_bwd_stats. rows_per_block, nblk: the slabs, as
// above. vec != 0: x, g and dx are 16-byte aligned and C is a multiple of 16
// bytes' worth of elements.
int medimgen_gn_bwd_apply(const void* x, const void* g, const float* A, const float* b,
                          const float* coef, void* dx, int B, long long M, int C, int dtype,
                          int silu, long long rows_per_block, int nblk, int vec, void* stream) {
    if (B < 1 || !valid(dtype, M, C, rows_per_block, nblk, vec, x, g, dx))
        return (int)cudaErrorInvalidValue;
    const ApplyArgs a{x, g, A, b, coef, dx, B, M, C, rows_per_block, nblk,
                      static_cast<cudaStream_t>(stream)};
    if (dtype == 1) return vec ? bwd_apply_act<bf16, 8>(a, silu) : bwd_apply_act<bf16, 1>(a, silu);
    return vec ? bwd_apply_act<float, 4>(a, silu) : bwd_apply_act<float, 1>(a, silu);
}

}  // extern "C"
