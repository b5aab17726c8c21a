// Voxel-hash nearest-neighbour query for Hopper (sm_90a).
//
// Replaces both perception_tpu/ops/voxelhash.py::_query_kernel_pallas
// (table resident in VMEM, up to 49152 rows) and ::_query_kernel_pallas_stream
// (larger tables streamed from HBM). The two exist on the TPU only because
// of a compiler limit on VMEM-resident operands; here one kernel serves
// every table size, with no size branch.
//
// Per query tile i (one block, one thread per query), over the tile's
// contiguous range of the cell-sorted table, rows
// [start[i], start[i] + nchunk[i] * rblk):
//
//   idx[q] = first index of the minimum of (q - p)^2,  d2[q] = that minimum,
//
// starting from d2 = 4e12 and idx = 0, as the Pallas kernels do. The block
// reads its own start and chunk count from device memory, so the host never
// waits for the card. The range is staged through shared memory in chunks
// of rblk rows of [x, y, z, 1] (8 KB at rblk = 512); every thread reads the
// same row at once (a broadcast), and the scan runs in ascending row order
// with strict '<', which keeps the first index of the minimum.
//
// Arithmetic: d2 = (dx*dx + dy*dy) + dz*dz with dx = q - p, each operation
// __fsub_rn / __fmul_rn / __fadd_rn (never contracted into an FMA), in the
// plain PyTorch version's order: the two are bit-identical.
//
// Bound: per tile, nchunk * rblk * 16 bytes from L2/HBM and
// tile * nchunk * rblk * 8 flops. At the odometry shapes (2048 sorted
// queries, 128-query tiles, ranges of a few chunks over a 33792-row table)
// the whole query is a few Mflop: launch- and latency-bound, with only
// Nq / tile blocks (16) on the card's 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRblk = 512;        // shared-memory stage (rows of float4)
constexpr float kFar = 4.0e12f;      // > (2 * SENTINEL)^2: no candidate yet

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void voxelhash_query_kernel(const float* __restrict__ queries,  // (Nqp, 3)
                                       const float* __restrict__ table,    // (Npad, 8)
                                       const int32_t* __restrict__ start,  // (ntiles,) rows
                                       const int32_t* __restrict__ nchunk, // (ntiles,)
                                       int npad, int rblk,
                                       int32_t* __restrict__ idx_out,      // (Nqp,)
                                       float* __restrict__ d2_out)         // (Nqp,)
{
    __shared__ float4 rows[kMaxRblk];
    const int q = blockIdx.x * blockDim.x + threadIdx.x;  // blockDim.x == tile
    const float qx = queries[(size_t)q * 3];
    const float qy = queries[(size_t)q * 3 + 1];
    const float qz = queries[(size_t)q * 3 + 2];
    const int s0 = start[blockIdx.x];
    const int nc = nchunk[blockIdx.x];

    float dmin = kFar;
    int imin = 0;
    for (int c = 0; c < nc; ++c) {
        const int off = s0 + c * rblk;
        const int m = min(rblk, npad - off);  // the range never passes the table
        __syncthreads();                      // the previous chunk is consumed
        for (int j = threadIdx.x; j < m; j += blockDim.x)
            rows[j] = *reinterpret_cast<const float4*>(table + (size_t)(off + j) * 8);
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            const float4 p = rows[j];
            const float dx = sub(qx, p.x), dy = sub(qy, p.y), dz = sub(qz, p.z);
            const float d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
            if (d2 < dmin) {
                dmin = d2;
                imin = off + j;
            }
        }
    }
    idx_out[q] = imin;
    d2_out[q] = dmin;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). The caller checks
// shapes, types and contiguity; nqp is a multiple of tile, tile <= 1024,
// 0 < rblk <= 512, and every range lies inside the table.
extern "C" int voxelhash_query_launch(const void* queries, const void* table, const void* start,
                                      const void* nchunk, int nqp, int npad, int tile, int rblk,
                                      void* idx, void* d2, void* stream)
{
    if (rblk <= 0 || rblk > kMaxRblk) return static_cast<int>(cudaErrorInvalidValue);
    voxelhash_query_kernel<<<nqp / tile, tile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const float*>(table),
        static_cast<const int32_t*>(start), static_cast<const int32_t*>(nchunk), npad, rblk,
        static_cast<int32_t*>(idx), static_cast<float*>(d2));
    return static_cast<int>(cudaGetLastError());
}
