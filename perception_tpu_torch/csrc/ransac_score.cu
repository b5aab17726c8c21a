// Fused RANSAC hypothesis scoring for Hopper (sm_90a).
//
// Replaces perception_tpu/ops/pallas/ransac_score.py::ransac_score_pallas:
//
//   score[b, k] = sum_i mask[b, i] * (|((x_i*a_k + y_i*b_k) + z_i*c_k) + d_k| <= tau)
//
// The (N, K) distance matrix never reaches memory. Each block stages one
// chunk of points (x, y, z, mask) in shared memory; each thread keeps one
// hypothesis in registers and counts its inliers over the chunk; the
// per-chunk counts are merged with int32 atomicAdd. Integer sums are exact
// in any order, so the result is deterministic.
//
// Arithmetic: __fmul_rn / __fadd_rn are never contracted into FMA (plain
// a*b+c would be, under nvcc's default --fmad=true), so each distance rounds
// exactly like the plain PyTorch version's separate multiplies and adds, and
// the counts are bit-identical to it.
//
// Bound: per frame the kernel reads N*16 + K*16 bytes and does N*K*7 flops
// (N=8192, K=1024: 0.15 MB against 59 Mflop), so it is compute- and
// occupancy-bound, never bound by memory bandwidth. N is split over
// blockIdx.y so that one frame alone gives (K/128) * (N/512) = 128 blocks,
// about one per SM; frames go on blockIdx.z.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // hypotheses per block, one per thread
constexpr int kChunk = 512;    // points per block, staged in shared memory

__global__ void __launch_bounds__(kThreads)
ransac_score_kernel(const float* __restrict__ points,  // (B, N, 3)
                    const uint8_t* __restrict__ mask,  // (B, N) bool bytes
                    const float4* __restrict__ hyp,    // (B, K) x [a, b, c, d]
                    int n, int k, float tau,
                    int32_t* __restrict__ out)         // (B, K), zeroed
{
    __shared__ float4 tile[kChunk];
    const int b = blockIdx.z;
    const int n0 = blockIdx.y * kChunk;
    const int m = min(kChunk, n - n0);
    const float* pts = points + (size_t)b * n * 3;
    const uint8_t* msk = mask + (size_t)b * n;
    for (int i = threadIdx.x; i < m; i += kThreads) {
        const int p = n0 + i;
        tile[i] = make_float4(pts[3 * p], pts[3 * p + 1], pts[3 * p + 2],
                              msk[p] ? 1.0f : 0.0f);
    }
    __syncthreads();

    const int h = blockIdx.x * kThreads + threadIdx.x;
    if (h >= k) return;
    const float4 pl = hyp[(size_t)b * k + h];
    int count = 0;
    for (int i = 0; i < m; ++i) {
        const float4 p = tile[i];  // same address across the warp: a broadcast
        float dist = __fadd_rn(__fmul_rn(p.x, pl.x), __fmul_rn(p.y, pl.y));
        dist = __fadd_rn(dist, __fmul_rn(p.z, pl.z));
        dist = __fadd_rn(dist, pl.w);
        count += (p.w != 0.0f) & (fabsf(dist) <= tau);
    }
    if (count) atomicAdd(out + (size_t)b * k + h, count);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); the caller checks
// shapes, types and alignment, and zeroes `out`.
extern "C" int ransac_score_launch(const void* points, const void* mask, const void* hyp,
                                   int batch, int n, int k, float tau, void* out,
                                   void* stream)
{
    const dim3 grid((k + kThreads - 1) / kThreads, (n + kChunk - 1) / kChunk, batch);
    ransac_score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
        static_cast<const float4*>(hyp), n, k, tau, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
