// Fused RANSAC hypothesis scoring for Hopper (sm_90a).
//
// Replaces perception_tpu/ops/pallas/ransac_score.py::ransac_score_pallas:
//
//   score[b, k] = sum_i mask[b, i] * (|((x_i*a_k + y_i*b_k) + z_i*c_k) + d_k| <= tau)
//
// The (N, K) distance matrix never reaches memory. A block holds
// kHypBlock = 128 hypotheses, kHyp = 4 in registers per lane, shared by
// its kWarps = 8 warps, and scans one split of the frame's points: a
// whole number of kChunk = 256-point chunks, staged in shared memory
// (double-buffered, the next chunk's loads in flight during the current
// chunk's scan). Each warp takes kChunk / kWarps points of a chunk, so one
// broadcast read of a point feeds kHyp independent distance chains.
// Masked points and the padding past N are staged as a quiet NaN, which
// no comparison accepts, so the inner loop has no mask test and no bound
// check: it is fully unrolled over the warp's points. A lane counts in
// float32 (the compare writes 1.0 or 0.0 and one add takes it: 8
// instructions a pair, where an int count takes 9), exact while a
// split holds at most 2^24 points. A block's counts are summed over its
// warps in shared memory and merged into the zeroed output with one int32
// atomicAdd per hypothesis; integer sums are exact in any order, so the
// result is deterministic.
//
// A point is staged as (0, x, y, z): its x, y and z then sit in odd
// registers of the LDS.128's quad, the hypotheses' a, b and c in even
// ones, and the multiplies read their operands from different register
// banks. The staging loads the mask and the point at once, with the
// index clamped in range, so a block's first chunk waits for one round
// trip, not two.
//
// Arithmetic: __fmul_rn / __fadd_rn are never contracted into FMA (plain
// a*b+c would be, under nvcc's default --fmad=true), so each distance rounds
// exactly like the plain PyTorch version's separate multiplies and adds, and
// the counts are bit-identical to it. A valid NaN or infinite point gives a
// NaN or infinite distance there too, and counts 0 in both.
//
// Bound: per frame the kernel reads N*13 + K*16 bytes and does N*K*8
// instructions (3 multiplies, 3 adds, the compare, the count; no FMA), so
// it is bound by the issue rate, never by memory bandwidth. The grid is
// (K / 128, splits, B); ops/kernels/ransac_score.py::launch_plan sizes the
// splits so that every path shape puts at least 8 warps on each SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHyp = 4;                      // hypotheses per lane
constexpr int kWarps = 8;                    // warps per block, sharing the hypotheses
constexpr int kThreads = 32 * kWarps;
constexpr int kHypBlock = 32 * kHyp;         // hypotheses per block
constexpr int kChunk = kThreads;             // points per staged chunk, one per thread
constexpr int kWarpPoints = kChunk / kWarps; // points of a chunk per warp

// Thread t's point of chunk c as (0, x, y, z), x, y and z a quiet NaN
// where masked or past n.
__device__ __forceinline__ float4 stage_point(const float* pts, const uint8_t* msk, int n, int c)
{
    const int p = c * kChunk + threadIdx.x;
    const int q = min(p, n - 1);
    const bool valid = (p < n) & (msk[q] != 0);
    const float x = pts[3 * q], y = pts[3 * q + 1], z = pts[3 * q + 2];
    const float nan = __int_as_float(0x7fc00000);
    return make_float4(0.0f, valid ? x : nan, valid ? y : nan, valid ? z : nan);
}

// At most 64 registers a thread, so the plan's 4 blocks an SM are all resident.
__global__ void __launch_bounds__(kThreads, 4)
ransac_score_kernel(const float* __restrict__ points,  // (B, N, 3)
                    const uint8_t* __restrict__ mask,  // (B, N) bool bytes
                    const float4* __restrict__ hyp,    // (B, K) x [a, b, c, d]
                    int n, int k, float tau, int split_chunks,
                    int32_t* __restrict__ out)         // (B, K), zeroed
{
    __shared__ float4 tile[2][kChunk];
    __shared__ int red[kHypBlock];
    const int b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int h0 = blockIdx.x * kHypBlock;
    const float* pts = points + (size_t)b * n * 3;
    const uint8_t* msk = mask + (size_t)b * n;
    const int c0 = blockIdx.y * split_chunks;
    const int chunks = min(split_chunks, (n + kChunk - 1) / kChunk - c0);

    float4 next = stage_point(pts, msk, n, c0);
    float4 pl[kHyp];  // lane's hypotheses h0 + 32 j + lane; padding past k is scored, never written
#pragma unroll
    for (int j = 0; j < kHyp; ++j) {
        const int h = h0 + 32 * j + lane;
        pl[j] = h < k ? hyp[(size_t)b * k + h] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (threadIdx.x < kHypBlock) red[threadIdx.x] = 0;
    tile[0][threadIdx.x] = next;
    __syncthreads();

    float count[kHyp];
#pragma unroll
    for (int j = 0; j < kHyp; ++j) count[j] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks) next = stage_point(pts, msk, n, c0 + c + 1);
        const float4* t = tile[c & 1] + warp * kWarpPoints;
#pragma unroll
        for (int i = 0; i < kWarpPoints; ++i) {
            const float4 p = t[i];  // (0, x, y, z), the same address across the warp: a broadcast
#pragma unroll
            for (int j = 0; j < kHyp; ++j) {
                float dist = __fadd_rn(__fmul_rn(p.y, pl[j].x), __fmul_rn(p.z, pl[j].y));
                dist = __fadd_rn(dist, __fmul_rn(p.w, pl[j].z));
                dist = __fadd_rn(dist, pl[j].w);
                count[j] = __fadd_rn(count[j], fabsf(dist) <= tau ? 1.0f : 0.0f);
            }
        }
        // The other buffer's readers finished before the last barrier.
        if (c + 1 < chunks) tile[(c + 1) & 1][threadIdx.x] = next;
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kHyp; ++j)
        if (count[j] != 0.0f) atomicAdd(&red[32 * j + lane], static_cast<int>(count[j]));
    __syncthreads();
    if (threadIdx.x < kHypBlock) {
        const int h = h0 + threadIdx.x;
        const int total = red[threadIdx.x];
        if (h < k && total) atomicAdd(out + (size_t)b * k + h, total);
    }
}

}  // namespace

// Launches on `stream` with `splits` blocks of `split_chunks` chunks along
// N (the caller's launch plan, for `chunk` points a chunk and
// `hyps_per_block` hypotheses a block, which must be this build's; at
// most 2^24 points a split, where the float counts are exact) and
// returns cudaGetLastError(); the caller checks shapes, types and
// alignment, and zeroes `out`.
extern "C" int ransac_score_launch(const void* points, const void* mask, const void* hyp,
                                   int batch, int n, int k, float tau, int chunk,
                                   int hyps_per_block, int split_chunks, int splits,
                                   void* out, void* stream)
{
    if (chunk != kChunk || hyps_per_block != kHypBlock || split_chunks < 1 ||
        split_chunks > (1 << 24) / kChunk || (long long)splits * split_chunks * kChunk < n)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((k + kHypBlock - 1) / kHypBlock, splits, batch);
    ransac_score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const uint8_t*>(mask),
        static_cast<const float4*>(hyp), n, k, tau, split_chunks, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
