// Fused Gauss-Newton ICP system for Hopper (sm_90a).
//
// Replaces perception_tpu/ops/pallas/icp_gn.py::gn_system_packed (its
// _kernel). For each restart r and each source point p (a row of src8):
//
//   1. p' = R p + t from the restart's 16 scalars (max_d2, huber, R, t);
//   2. the nearest target by d2 = |p'|^2 - 2 (p'.t - |t|^2 / 2), the
//      first index of the minimum over all targets;
//   3. that target's point q and normal n, loaded straight from tn;
//   4. r = n.(p' - q), gate = valid & d2 <= max_d2, Huber weight w;
//   5. M += w Jhat^T Jhat with Jhat = [n, p' x n, r, 1], and the stats
//      [sum gate, sum gate * max(d2, 0)].
//
// Layout: one thread per source point, grid (ceil(Np / kThreads), R).
// Each block stages the targets in chunks of kChunk rows of
// [x, y, z, -|t|^2 / 2] (16 KB) in shared memory; every thread of the
// block reads the same row at once (a broadcast) and keeps a running
// minimum with strict '<' in ascending target order, which is the first
// index of the minimum: the Pallas rule (argmin within a chunk, the
// lower chunk on cross-chunk ties). Mosaic has no gather, so the Pallas
// kernel gathers q and n with a one-hot matmul; here it is one load.
//
// Reduction: each thread holds the 36 upper-triangle entries of its
// w Jhat^T Jhat and the 2 stats; a warp shuffle tree and a fixed-order
// sum over the block's warps give one row of partials per block, and
// icp_gn_finish_kernel sums the rows of a restart in block order. No
// atomics: the result is the same on every run.
//
// Arithmetic: every multiply, add and subtract of the transform and the
// distance is __fmul_rn / __fadd_rn / __fsub_rn, never contracted into
// an FMA, in the plain PyTorch version's order, so the two versions find
// the same nearest neighbours; M and the stats then differ only by the
// order of their float sums.
//
// Bound: N * M * ~10 flops per restart (4096 x 8192: 0.34 Gflop) against
// M * 16 bytes of target traffic per block, from L2 after the first
// block: compute- and latency-bound. The grid has only Np / kThreads
// blocks per restart (16 at N = 4096), fewer than the card's 132 SMs;
// splitting the target axis over blocks is the next step for speed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // source points per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;             // target rows per shared-memory stage
constexpr int kSums = 38;                // 36 entries of M (i <= j) + 2 stats

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kThreads)
icp_gn_partial_kernel(const float* __restrict__ src8,     // (R, Np, 8)
                      const float* __restrict__ tgtd,     // (Mp, 8) [x, y, z, |t|^2, 0..]
                      const float* __restrict__ tn,       // (Mp, 8) [x, y, z, nx, ny, nz, 0, 0]
                      const float* __restrict__ scalars,  // (R, 16)
                      int np, int mp,
                      float* __restrict__ partials)       // (R, gridDim.x, kSums)
{
    __shared__ float4 tile[kChunk];
    __shared__ float warp_sums[kWarps][kSums];

    const int r = blockIdx.y;
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const bool live = i < np;
    const float* sc = scalars + (size_t)r * 16;

    float x = 0.0f, y = 0.0f, z = 0.0f, valid = 0.0f;
    if (live) {
        const float* s = src8 + ((size_t)r * np + i) * 8;
        const float x0 = s[0], y0 = s[1], z0 = s[2];
        valid = s[4];
        x = add(add(add(mul(sc[2], x0), mul(sc[3], y0)), mul(sc[4], z0)), sc[11]);
        y = add(add(add(mul(sc[5], x0), mul(sc[6], y0)), mul(sc[7], z0)), sc[12]);
        z = add(add(add(mul(sc[8], x0), mul(sc[9], y0)), mul(sc[10], z0)), sc[13]);
    }
    const float p_sq = add(add(mul(x, x), mul(y, y)), mul(z, z));

    float dmin = INFINITY;
    int best = 0;
    for (int c0 = 0; c0 < mp; c0 += kChunk) {
        const int m = min(kChunk, mp - c0);
        __syncthreads();  // the previous chunk is consumed
        for (int j = threadIdx.x; j < m; j += kThreads) {
            const float4 t = *reinterpret_cast<const float4*>(tgtd + (size_t)(c0 + j) * 8);
            tile[j] = make_float4(t.x, t.y, t.z, mul(-0.5f, t.w));  // exact: a power of 2
        }
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            const float4 t = tile[j];
            const float half = add(add(add(mul(x, t.x), mul(y, t.y)), mul(z, t.z)), t.w);
            const float d2 = sub(p_sq, mul(2.0f, half));
            if (d2 < dmin) {
                dmin = d2;
                best = c0 + j;
            }
        }
    }

    float v[kSums];
    if (live) {
        const float* q = tn + (size_t)best * 8;
        const float n0 = q[3], n1 = q[4], n2 = q[5];
        const float gate = (dmin <= sc[0] && valid > 0.5f) ? 1.0f : 0.0f;
        const float dx = sub(x, q[0]), dy = sub(y, q[1]), dz = sub(z, q[2]);
        const float res = add(add(mul(n0, dx), mul(n1, dy)), mul(n2, dz));
        const float absr = fabsf(res);
        const float huber = sc[1];
        const float w = mul(gate, absr <= huber ? 1.0f : __fdiv_rn(huber, fmaxf(absr, 1e-12f)));
        const float jhat[8] = {
            n0, n1, n2,
            sub(mul(y, n2), mul(z, n1)),
            sub(mul(z, n0), mul(x, n2)),
            sub(mul(x, n1), mul(y, n0)),
            res, 1.0f,
        };
        int k = 0;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            const float jw = mul(jhat[a], w);
#pragma unroll
            for (int b = a; b < 8; ++b) v[k++] = mul(jw, jhat[b]);
        }
        v[36] = gate;
        v[37] = mul(fmaxf(dmin, 0.0f), gate);
    } else {
#pragma unroll
        for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
    }

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
        float s = v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) warp_sums[warp][k] = s;
    }
    __syncthreads();
    if (threadIdx.x < kSums) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
        partials[((size_t)r * gridDim.x + blockIdx.x) * kSums + threadIdx.x] = s;
    }
}

// One block per restart, one thread per sum: adds the blocks' partials in
// block order and writes the symmetric 8x8 system and the 2 stats.
__global__ void icp_gn_finish_kernel(const float* __restrict__ partials, int nblocks,
                                     float* __restrict__ out,     // (R, 8, 8)
                                     float* __restrict__ stats)   // (R, 2)
{
    const int r = blockIdx.x;
    const int k = threadIdx.x;
    if (k >= kSums) return;
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b) s += partials[((size_t)r * nblocks + b) * kSums + k];
    if (k >= 36) {
        stats[r * 2 + (k - 36)] = s;
        return;
    }
    int a = 0, rem = k;
    while (rem >= 8 - a) {  // row a of the upper triangle holds 8 - a entries
        rem -= 8 - a;
        ++a;
    }
    const int b = a + rem;
    out[r * 64 + a * 8 + b] = s;
    out[r * 64 + b * 8 + a] = s;
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError(). The
// caller checks shapes, types and contiguity, requires np, mp, r > 0,
// and allocates `partials` as (r, ceil(np / 256), 38) floats.
extern "C" int icp_gn_launch(const void* src8, const void* tgtd, const void* tn,
                             const void* scalars, int r, int np, int mp,
                             void* partials, void* out, void* stats, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nblocks = (np + kThreads - 1) / kThreads;
    icp_gn_partial_kernel<<<dim3(nblocks, r), kThreads, 0, s>>>(
        static_cast<const float*>(src8), static_cast<const float*>(tgtd),
        static_cast<const float*>(tn), static_cast<const float*>(scalars), np, mp,
        static_cast<float*>(partials));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    icp_gn_finish_kernel<<<r, 64, 0, s>>>(static_cast<const float*>(partials), nblocks,
                                           static_cast<float*>(out), static_cast<float*>(stats));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int icp_gn_threads_per_block() { return kThreads; }
