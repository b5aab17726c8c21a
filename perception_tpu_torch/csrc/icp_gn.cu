// Fused Gauss-Newton ICP system for Hopper (sm_90a).
//
// Replaces perception_tpu/ops/pallas/icp_gn.py::gn_system_packed (its
// _kernel). For each restart r and each source point p (a row of src8):
//
//   1. p' = R p + t from the restart's pose Ts[r] (4x4, row-major);
//   2. the nearest target by d2 = |p'|^2 - 2 (p'.t - |t|^2 / 2), the
//      first index of the minimum over all targets;
//   3. that target's point q and normal n, loaded straight from tn;
//   4. r = n.(p' - q), gate = valid & d2 <= max_d2, Huber weight w;
//   5. M += w Jhat^T Jhat with Jhat = [n, p' x n, r, 1], and the stats
//      [sum gate, sum gate * max(d2, 0)].
//
// Three kernels, launched together by icp_gn_launch:
//
// icp_gn_nn_kernel (steps 1-2), grid (source tiles, target splits, R).
// The target axis is cut into `splits` ascending ranges of `split_rows`
// rows (a multiple of kChunk), so the grid fills the card even when a
// restart has only a few thousand source points: the wrapper's launch
// plan picks the split count from the shapes and the SM count alone.
// Each of the block's 64 threads keeps kPts = 4 source points in
// registers, so one shared-memory row (a broadcast float4) feeds four
// independent distance chains. Target chunks of [x, y, z, |t|^2] are
// staged through a kStages-deep ring in shared memory with cp.async, so
// the next chunks land while the current one is scanned. Within its
// split a thread keeps a running minimum with strict '<' in ascending
// target order: the first index of the split's minimum. It writes
// (d2, index) per point and split as one 8-byte word.
//
// icp_gn_system_kernel (steps 3-5), one thread per source point, 256 a
// block: merges the splits' (d2, index) in split order with strict '<'
// (so the lower split, and so the lower index, wins a tie: the first
// index of the global minimum, whatever order the NN blocks ran in),
// recomputes p' with the same rounding, and sums the 36 upper-triangle
// entries of w Jhat^T Jhat and the 2 stats by a warp shuffle tree and a
// fixed-order sum over the block's warps.
//
// icp_gn_finish_kernel sums the rows of a restart in block order. No
// atomics anywhere: the result is the same on every run, and M and the
// stats are bit-identical to the earlier one-kernel design's.
//
// Arithmetic: every multiply, add and subtract of the transform and the
// distance is __fmul_rn / __fadd_rn / __fsub_rn, never contracted into
// an FMA, in the plain PyTorch version's order, so the two versions find
// the same nearest neighbours; M and the stats then differ only by the
// order of their float sums. Tensor cores are not used: a TF32 or bf16
// product rounds p'.t differently, which changes which neighbour wins
// and the gate counts.
//
// Bound: about 10 operations per (source, target) pair (3 multiplies and
// 3 adds for p'.t - |t|^2/2, the doubling, the subtraction, the compare,
// the select), no FMA: 4096 x 8192 is 0.34 Gop, 5.0 us at the card's
// 67 TFLOP/s f32 rate; the inputs (a few hundred KB) are under 0.4 us at
// 3.35 TB/s. So it is compute-bound. Without FMA each operation is one
// instruction, and the card issues at most half its FMA flop rate in
// instructions, so the NN phase cannot pass half of that bound. The
// earlier design ran one block per 256 source points (16 blocks on 132
// SMs at 4096 x 8192), one dependent chain per thread and synchronous
// staging; this one aims at 16 blocks per SM where the shapes allow (at
// least 512 blocks at the odometry and SLAM shapes), 4 chains per thread,
// and asynchronous copies.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // system phase: source points per block
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 38;                  // 36 entries of M (i <= j) + 2 stats
constexpr int kNnThreads = 64;             // NN phase: threads per block
constexpr int kPts = 4;                    // source points per NN thread
constexpr int kSrcTile = kNnThreads * kPts;
constexpr int kChunk = 64;                 // target rows per shared-memory stage
constexpr int kStages = 3;                 // depth of the cp.async ring

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem)
{
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// p' = R p + t of source row s under the pose T (4x4, row-major).
__device__ __forceinline__ void transform(const float* T, const float* s, float& x, float& y,
                                          float& z)
{
    const float x0 = s[0], y0 = s[1], z0 = s[2];
    x = add(add(add(mul(T[0], x0), mul(T[1], y0)), mul(T[2], z0)), T[3]);
    y = add(add(add(mul(T[4], x0), mul(T[5], y0)), mul(T[6], z0)), T[7]);
    z = add(add(add(mul(T[8], x0), mul(T[9], y0)), mul(T[10], z0)), T[11]);
}

__global__ void __launch_bounds__(kNnThreads)
icp_gn_nn_kernel(const float* __restrict__ src8,     // (R, Np, 8)
                 const float* __restrict__ tgtd,     // (Mp, 8) [x, y, z, |t|^2, 0..]
                 const float* __restrict__ Ts,       // (R, 4, 4)
                 int np, int mp, int split_rows,
                 int2* __restrict__ nn)              // (R, splits, Np) [d2 bits, index]
{
    __shared__ __align__(16) float4 ring[kStages][kChunk];

    const int r = blockIdx.z;
    const float* T = Ts + (size_t)r * 16;
    float x[kPts], y[kPts], z[kPts], p_sq[kPts], dmin[kPts];
    int best[kPts];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
        const int i = blockIdx.x * kSrcTile + k * kNnThreads + threadIdx.x;
        x[k] = y[k] = z[k] = 0.0f;
        if (i < np) transform(T, src8 + ((size_t)r * np + i) * 8, x[k], y[k], z[k]);
        p_sq[k] = add(add(mul(x[k], x[k]), mul(y[k], y[k])), mul(z[k], z[k]));
        dmin[k] = INFINITY;
        best[k] = 0;
    }

    const int row0 = blockIdx.y * split_rows;
    const int row1 = min(row0 + split_rows, mp);
    const int nchunks = row1 > row0 ? (row1 - row0 + kChunk - 1) / kChunk : 0;
    // Chunk c goes to ring slot c % kStages; every thread commits one group
    // per chunk index, empty past the end, so the group counts agree.
    auto issue = [&](int c) {
        if (c < nchunks) {
            const int c0 = row0 + c * kChunk;
            const int m = min(kChunk, row1 - c0);
            for (int j = threadIdx.x; j < m; j += kNnThreads)
                cp_async16(&ring[c % kStages][j], tgtd + (size_t)(c0 + j) * 8);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) issue(c);

    for (int c = 0; c < nchunks; ++c) {
        cp_async_wait<kStages - 2>();  // this thread's copies of chunk c landed
        __syncthreads();               // everyone's landed; chunk c - 1 is consumed
        issue(c + kStages - 1);        // into chunk c - 1's slot
        const float4* tile = ring[c % kStages];
        const int c0 = row0 + c * kChunk;
        const int m = min(kChunk, row1 - c0);
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
            const float4 t = tile[j];  // same address across the warp: a broadcast
            const float tw = mul(-0.5f, t.w);  // exact: a power of 2
#pragma unroll
            for (int k = 0; k < kPts; ++k) {
                const float half = add(add(add(mul(x[k], t.x), mul(y[k], t.y)), mul(z[k], t.z)), tw);
                const float d2 = sub(p_sq[k], mul(2.0f, half));
                if (d2 < dmin[k]) {
                    dmin[k] = d2;
                    best[k] = c0 + j;
                }
            }
        }
    }

#pragma unroll
    for (int k = 0; k < kPts; ++k) {
        const int i = blockIdx.x * kSrcTile + k * kNnThreads + threadIdx.x;
        if (i < np)
            nn[((size_t)r * gridDim.y + blockIdx.y) * np + i] = make_int2(__float_as_int(dmin[k]), best[k]);
    }
}

__global__ void __launch_bounds__(kThreads)
icp_gn_system_kernel(const float* __restrict__ src8,     // (R, Np, 8)
                     const float* __restrict__ tn,       // (Mp, 8) [x, y, z, nx, ny, nz, 0, 0]
                     const float* __restrict__ Ts,       // (R, 4, 4)
                     const int2* __restrict__ nn,        // (R, splits, Np) [d2 bits, index]
                     int np, int splits, float max_d2, float huber,
                     float* __restrict__ partials)       // (R, gridDim.x, kSums)
{
    __shared__ float warp_sums[kWarps][kSums];

    const int r = blockIdx.y;
    const int i = blockIdx.x * kThreads + threadIdx.x;

    float v[kSums];
    if (i < np) {
        const float* s = src8 + ((size_t)r * np + i) * 8;
        const float valid = s[4];
        float x, y, z;
        transform(Ts + (size_t)r * 16, s, x, y, z);
        float dmin = INFINITY;
        int best = 0;
#pragma unroll 16
        for (int k = 0; k < splits; ++k) {  // ascending splits: a tie keeps the lower index
            const int2 c = nn[((size_t)r * splits + k) * np + i];
            const float d2 = __int_as_float(c.x);
            if (d2 < dmin) {
                dmin = d2;
                best = c.y;
            }
        }
        const float* q = tn + (size_t)best * 8;
        const float n0 = q[3], n1 = q[4], n2 = q[5];
        const float gate = (dmin <= max_d2 && valid > 0.5f) ? 1.0f : 0.0f;
        const float dx = sub(x, q[0]), dy = sub(y, q[1]), dz = sub(z, q[2]);
        const float res = add(add(mul(n0, dx), mul(n1, dy)), mul(n2, dz));
        const float absr = fabsf(res);
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

// Launches the three kernels on `stream` and returns cudaGetLastError().
// max_d2 and huber are the correspondence gate (squared) and the Huber
// delta, as float32. The caller checks shapes, types, contiguity and
// 16-byte alignment of tgtd, requires np, mp, r > 0, and allocates `nn` as r * splits * np
// 8-byte words (8-byte aligned) and `partials` as
// (r, ceil(np / 256), 38) floats. The splits must tile [0, mp) in order:
// split_rows a positive multiple of the stage chunk, and
// (splits - 1) * split_rows < mp <= splits * split_rows.
extern "C" int icp_gn_launch(const void* src8, const void* tgtd, const void* tn, const void* Ts,
                             float max_d2, float huber, int r, int np, int mp, int splits,
                             int split_rows, void* nn, void* partials, void* out, void* stats,
                             void* stream)
{
    if (split_rows <= 0 || split_rows % kChunk || splits <= 0 || splits > 65535 ||
        (long long)(splits - 1) * split_rows >= mp || (long long)splits * split_rows < mp)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    int2* nn_pairs = static_cast<int2*>(nn);
    const float* T = static_cast<const float*>(Ts);
    const float* src = static_cast<const float*>(src8);

    icp_gn_nn_kernel<<<dim3((np + kSrcTile - 1) / kSrcTile, splits, r), kNnThreads, 0, s>>>(
        src, static_cast<const float*>(tgtd), T, np, mp, split_rows, nn_pairs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nblocks = (np + kThreads - 1) / kThreads;
    icp_gn_system_kernel<<<dim3(nblocks, r), kThreads, 0, s>>>(
        src, static_cast<const float*>(tn), T, nn_pairs, np, splits, max_d2, huber,
        static_cast<float*>(partials));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    icp_gn_finish_kernel<<<r, 64, 0, s>>>(static_cast<const float*>(partials), nblocks,
                                           static_cast<float*>(out), static_cast<float*>(stats));
    return static_cast<int>(cudaGetLastError());
}

// The geometry the wrapper's launch plan must agree with: system-phase
// threads per block, source points per NN block, target rows per stage.
extern "C" void icp_gn_geometry(int* out)
{
    out[0] = kThreads;
    out[1] = kSrcTile;
    out[2] = kChunk;
}
