// Voxel-hash nearest-neighbour query for Hopper (sm_90a).
//
// Replaces both perception_tpu/ops/voxelhash.py::_query_kernel_pallas
// (table resident in VMEM, up to 49152 rows) and ::_query_kernel_pallas_stream
// (larger tables streamed from HBM). The two exist on the TPU only because
// of a compiler limit on VMEM-resident operands; here one kernel serves
// every table size, with no size branch.
//
// Per query tile i, over the tile's contiguous range of the cell-sorted
// table, rows [start[i], start[i] + min(nchunk[i] * rblk, R)):
//
//   idx[q] = first index of the minimum of (q - p)^2,  d2[q] = that minimum,
//
// starting from d2 = 4e12 and idx = 0, as the Pallas kernels do: a
// candidate must be strictly nearer than 4e12 to replace index 0.
//
// Two kernels, launched together by voxelhash_query_launch:
//
// voxelhash_scan_kernel, grid (tiles, pieces). The range is cut into
// pieces of `piece_rows` rows (at most 512); the piece count is fixed on
// the host from R, so the host never waits for the card. A block reads its
// tile's start and chunk count from device memory and returns at once when
// its piece lies past the tile's range. Otherwise its threads form up to
// four sub-blocks of one thread per query (whole warps), so an SM holds
// four times the warps of one thread per query; sub-block k scans the k-th
// contiguous quarter of the piece. Its threads copy those rows of
// [x, y, z, 1] themselves with cp.async in two groups, and meet at their
// own named barrier, so the sub-block scans the first half as soon as it
// has landed while the second is in flight. Every thread of a warp reads
// the same row at once (a broadcast) and keeps a running minimum with
// strict '<' in ascending row order, starting from (4e12, 0); the
// sub-blocks' minima merge in sub-block order through shared memory, and
// the block writes (d2, index) per query and piece as one 8-byte word.
//
// voxelhash_merge_kernel, one thread per query: merges the tile's live
// pieces in piece order with strict '<', starting from (4e12, 0), which
// gives the first index of the range's minimum whatever order the scan
// blocks ran in, and writes the int32 index and the f32 distance. No
// atomics: the output is the same on every run.
//
// Arithmetic: d2 = (dx*dx + dy*dy) + dz*dz with dx = q - p, each operation
// __fsub_rn / __fmul_rn / __fadd_rn (never contracted into an FMA), in the
// plain PyTorch version's order: the two are bit-identical. Tensor cores
// are not used (they would round the distances differently).
//
// Bound: 9 operations a (query, row) pair (3 subtracts, 3 multiplies, 2
// adds, a compare) over the rows the ranges hold, sum over tiles of
// tile * nchunk * rblk: data-dependent, at most 16 tiles * 128 * 16896
// rows (4.6 us at 67 TFLOP/s) for 2048 queries on a 33792-row table; the
// table rows read (16 bytes each) are under 0.2 us at 3.35 TB/s. So it is
// compute-bound. The earlier design ran one block per 128-query tile (16
// blocks on 132 SMs), scanned a tile's whole range as one dependent chain
// and staged synchronously, so the longest range set the time; this one
// spreads each range over up to R / piece_rows blocks, and each piece over
// four threads a query.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPiece = 512;                // rows of a piece (shared-memory stage)
constexpr int kMaxThreads = 1024;             // threads of a scan block (tile x subs)
constexpr int kMaxSubs = 4;                   // threads per query in a scan block
constexpr float kFar = 4.0e12f;               // > (2 * SENTINEL)^2: no candidate yet

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem)
{
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `pending` (0 or 1) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending)
{
    if (pending)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows of tile i's range: nchunk[i] chunks of rblk, capped at the window R.
__device__ __forceinline__ int range_rows(const int32_t* nchunk, int i, int rblk, int window)
{
    return min(nchunk[i] * rblk, window);
}

// Waits for the other threads of sub-block `sub`: a named barrier of
// `count` threads (a multiple of 32), or the whole block when there is
// one sub-block.
__device__ __forceinline__ void sub_sync(int sub, int subs, int count)
{
    if (subs == 1)
        __syncthreads();
    else
        asm volatile("bar.sync %0, %1;\n" ::"r"(sub + 1), "r"(count) : "memory");
}

__global__ void voxelhash_scan_kernel(const float* __restrict__ queries,  // (Nqp, 3)
                                      const float* __restrict__ table,    // (Npad, 8)
                                      const int32_t* __restrict__ start,  // (ntiles,) rows
                                      const int32_t* __restrict__ nchunk, // (ntiles,)
                                      int npad, int rblk, int window, int piece_rows, int tile,
                                      int2* __restrict__ part)            // (ntiles, pieces, tile)
{
    __shared__ __align__(16) float4 rows[kMaxPiece];
    __shared__ int2 best[kMaxThreads];
    const int i = blockIdx.x;
    const int lo = blockIdx.y * piece_rows;      // offset of the piece in the range
    const int span = range_rows(nchunk, i, rblk, window);
    if (lo >= span) return;                      // past the range: the merge skips it
    const int off = start[i] + lo;
    const int m = min(min(piece_rows, span - lo), npad - off);  // the range never passes the table

    // Sub-block `sub` scans rows [r0, r1) of the piece for the tile's queries;
    // its threads copy those rows themselves, in two cp.async groups, so it
    // starts on the first half as soon as that has landed.
    const int subs = blockDim.x / tile, sub = threadIdx.x / tile, lane = threadIdx.x % tile;
    const int per = (m + subs - 1) / subs;
    const int r0 = min(sub * per, m), r1 = min(r0 + per, m), mid = r0 + (r1 - r0 + 1) / 2;
    for (int j = r0 + lane; j < mid; j += tile) cp_async16(&rows[j], table + (size_t)(off + j) * 8);
    cp_async_commit();
    for (int j = mid + lane; j < r1; j += tile) cp_async16(&rows[j], table + (size_t)(off + j) * 8);
    cp_async_commit();

    const int q = i * tile + lane;
    const float qx = queries[(size_t)q * 3];
    const float qy = queries[(size_t)q * 3 + 1];
    const float qz = queries[(size_t)q * 3 + 2];
    float dmin = kFar;
    int imin = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        cp_async_wait(1 - half);                 // this thread's copies of the half landed
        sub_sync(sub, subs, tile);               // and the sub-block's
        const int a = half ? mid : r0, b = half ? r1 : mid;
#pragma unroll 4
        for (int j = a; j < b; ++j) {
            const float4 p = rows[j];            // same address across the warp: a broadcast
            const float dx = sub_rn(qx, p.x), dy = sub_rn(qy, p.y), dz = sub_rn(qz, p.z);
            const float d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
            if (d2 < dmin) {
                dmin = d2;
                imin = off + j;
            }
        }
    }
    // The sub-blocks' minima, merged in sub order (ascending rows) with strict '<'.
    best[threadIdx.x] = make_int2(__float_as_int(dmin), imin);
    __syncthreads();
    if (sub == 0) {
        for (int k = 1; k < subs; ++k) {
            const int2 c = best[k * tile + lane];
            if (__int_as_float(c.x) < dmin) {
                dmin = __int_as_float(c.x);
                imin = c.y;
            }
        }
        part[((size_t)i * gridDim.y + blockIdx.y) * tile + lane] = make_int2(__float_as_int(dmin), imin);
    }
}

__global__ void voxelhash_merge_kernel(const int32_t* __restrict__ nchunk,  // (ntiles,)
                                       int rblk, int window, int piece_rows, int pieces,
                                       const int2* __restrict__ part,      // [d2 bits, index]
                                       int32_t* __restrict__ idx_out,       // (Nqp,)
                                       float* __restrict__ d2_out)          // (Nqp,)
{
    const int i = blockIdx.x;
    const int span = range_rows(nchunk, i, rblk, window);
    const int live = min(pieces, (span + piece_rows - 1) / piece_rows);
    float dmin = kFar;
    int imin = 0;
#pragma unroll 8
    for (int p = 0; p < live; ++p) {  // ascending pieces: a tie keeps the lower index
        const int2 c = part[((size_t)i * pieces + p) * blockDim.x + threadIdx.x];
        const float d2 = __int_as_float(c.x);
        if (d2 < dmin) {
            dmin = d2;
            imin = c.y;
        }
    }
    const int q = i * blockDim.x + threadIdx.x;
    idx_out[q] = imin;
    d2_out[q] = dmin;
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError(). The
// caller checks shapes, types, contiguity and 16-byte alignment of the
// table; nqp is a multiple of tile, tile <= 1024, 0 < piece_rows <= 512,
// pieces * piece_rows >= window, every range lies inside the table, and
// `part` holds (nqp / tile) * pieces * tile 8-byte words (8-byte aligned).
extern "C" int voxelhash_query_launch(const void* queries, const void* table, const void* start,
                                      const void* nchunk, int nqp, int npad, int tile, int rblk,
                                      int window, int piece_rows, int pieces, void* part,
                                      void* idx, void* d2, void* stream)
{
    if (tile <= 0 || tile > 1024 || nqp % tile || rblk <= 0 || piece_rows <= 0 ||
        piece_rows > kMaxPiece || pieces <= 0 || pieces > 65535 ||
        (long long)pieces * piece_rows < window)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int ntiles = nqp / tile;
    int2* pairs = static_cast<int2*>(part);
    const int32_t* nc = static_cast<const int32_t*>(nchunk);

    // Up to kMaxSubs threads per query, in whole warps (named barriers).
    const int subs = tile % 32 ? 1 : min(kMaxSubs, kMaxThreads / tile);
    voxelhash_scan_kernel<<<dim3(ntiles, pieces), tile * subs, 0, s>>>(
        static_cast<const float*>(queries), static_cast<const float*>(table),
        static_cast<const int32_t*>(start), nc, npad, rblk, window, piece_rows, tile, pairs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    voxelhash_merge_kernel<<<ntiles, tile, 0, s>>>(nc, rblk, window, piece_rows, pieces, pairs,
                                                   static_cast<int32_t*>(idx),
                                                   static_cast<float*>(d2));
    return static_cast<int>(cudaGetLastError());
}
