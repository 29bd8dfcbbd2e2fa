// Multi-tensor kernels of the optimizer step for Hopper (sm_90a): one
// `MuonAdamAtan2.step` (dreamer4_torch/train/optim.py) over all of its
// parameters in a handful of launches.
//
// Replaces no Pallas kernel: the JAX package's optimizer is optax
// (dreamer4_tpu/train/optim.py `muon_adam_atan2`), whose elementwise chains
// XLA fuses. The port's plain version is a Python loop over the parameters,
// about 14 launches for each Adam parameter and several for each Muon one:
// some 3,600 launches a world-model step, each a few microseconds on the card
// and about ten on the host, so the host paced the step and the card idled.
// Here each phase is one launch over a table of tensors (more only where a
// launch's 4 KB of arguments cannot hold the table): one block takes one
// chunk of one tensor, found by a binary search over the chunks' prefix.
//
// Phases, in stream order (the wrapper is ops/multi_tensor.py):
//   clip      every gradient's float32 sum of squares per chunk of CHUNK
//             elements, then one block sums the chunks' sums and writes
//             scale = min(1, max_norm / max(sqrt(sum), 1e-16)) to the device.
//             Fixed order and no atomics, so a run repeats bitwise.
//   adam      Adam-atan2 over the Adam group: the clip scale read from the
//             device, the decay, both moments and the atan2 update in
//             registers, with the plain version's float32 operations in its
//             order (every product and sum rounded on its own, no fma).
//   muon      momentum and the Nesterov update u over the Muon group in
//             64 x 64 tiles; u goes to its matrix's place in the float32
//             Newton-Schulz stack in the stack's orientation (n >= m, through
//             a shared-memory transpose where that is the parameter's
//             transpose), with each tile's sum of u^2; then each matrix's
//             norm from its tiles' sums (fixed order) and the stack's bf16
//             input x = u / (norm + eps).
//   (Newton-Schulz itself is batched bf16 matmuls in torch.)
//   apply     p += coef * o over the Muon group, o read back from the
//             Newton-Schulz output in the parameter's own layout (the same
//             tile transpose).
//
// Bound: bytes. A world-model step (57.68M parameters, 32.0M of them Adam's)
// reads every gradient for the clip (231 MB), moves 28 bytes an Adam element
// (896 MB) and 32 a Muon element over momentum, normalization and apply
// (822 MB): 1.95 GB, 0.58 ms at 3.35 TB/s, beside Newton-Schulz's 303 GFLOP
// (0.31 ms at 989 TFLOP/s bf16). Every element is read and written
// once a phase, coalesced (tiles read and write whole 256-byte rows), with
// four elements of each tensor in flight a thread in the 1-D kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 16384;    // elements a block of the 1-D kernels takes
constexpr int TILE = 64;        // rows and columns of a Muon tile
constexpr int TILE_ROWS = THREADS / TILE;   // rows a pass of a tile covers
constexpr int ILP = 4;          // elements a thread loads before it computes
constexpr int ARG_BYTES = 4000; // under the 4 KB a launch's arguments may hold

// The table of one launch of the 1-D kernels: chunk b of the launch lies in
// the last tensor t whose begin[t] <= b.
__device__ __forceinline__ int entry_of(const int* begin, int count, int b) {
    int lo = 0, hi = count - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (begin[mid] <= b) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// Sum over the block in one fixed order: each warp by shuffles (16, 8, 4, 2,
// 1 lanes down), then warp 0 over the warps' sums the same way. Thread 0
// holds the result.
__device__ __forceinline__ float block_sum(float v) {
    __shared__ float warp_sums[WARPS];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    float s = 0.f;
    if (warp == 0) {
        s = lane < WARPS ? warp_sums[lane] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    }
    return s;
}

// ---------------------------------------------------------------- clip

struct ClipArgs {
    static constexpr int MAX = 200;
    const float* g[MAX];        // null: a parameter without a gradient
    int n[MAX];
    int begin[MAX + 1];
    int count;
    int base;                   // the global index of the launch's first chunk
};
static_assert(sizeof(ClipArgs) <= ARG_BYTES, "clip table over a launch's arguments");

// Thread t of a chunk adds the squares of the chunk's elements t, t + THREADS,
// t + 2 THREADS, ... in that order.
__global__ void __launch_bounds__(THREADS) clip_partials(const __grid_constant__ ClipArgs a,
                                                         float* __restrict__ partials) {
    const int b = blockIdx.x;
    const int t = entry_of(a.begin, a.count, b);
    const float* __restrict__ g = a.g[t];
    const int lo = (b - a.begin[t]) * CHUNK, hi = min(a.n[t], lo + CHUNK);
    float acc = 0.f;
    if (g != nullptr) {
        for (int base = lo; base < hi; base += THREADS * ILP) {
            float x[ILP];
#pragma unroll
            for (int k = 0; k < ILP; ++k) {
                const int i = base + k * THREADS + threadIdx.x;
                x[k] = i < hi ? g[i] : 0.f;
            }
#pragma unroll
            for (int k = 0; k < ILP; ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
        }
    }
    const float s = block_sum(acc);
    if (threadIdx.x == 0) partials[a.base + b] = s;
}

// The plain version's scale: clamp(max_norm * reciprocal(clamp(sqrt(sum),
// min=1e-16)), max=1), NaN kept as torch.clamp keeps it.
__global__ void __launch_bounds__(THREADS) clip_final(const float* __restrict__ partials,
                                                      int count, float max_norm,
                                                      float* __restrict__ scale) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < count; i += THREADS) acc = __fadd_rn(acc, partials[i]);
    const float s = block_sum(acc);
    if (threadIdx.x == 0) {
        float norm = __fsqrt_rn(s);
        norm = norm < 1e-16f ? 1e-16f : norm;
        const float c = __fmul_rn(__frcp_rn(norm), max_norm);
        *scale = c > 1.f ? 1.f : c;
    }
}

// ---------------------------------------------------------------- Adam-atan2

struct AdamArgs {
    static constexpr int MAX = 90;
    float* p[MAX];
    const float* g[MAX];
    float* mu[MAX];
    float* nu[MAX];
    int n[MAX];
    int begin[MAX + 1];
    int count;
};
static_assert(sizeof(AdamArgs) + 64 <= ARG_BYTES, "Adam table over a launch's arguments");

struct AdamScalars {
    float wd, b1, omb1, b2, omb2, c1, c2, b, neg_lr_a;
};

__global__ void __launch_bounds__(THREADS) adam_atan2(const __grid_constant__ AdamArgs a,
                                                      const float* __restrict__ scale,
                                                      const AdamScalars s) {
    const int b = blockIdx.x;
    const int t = entry_of(a.begin, a.count, b);
    float* __restrict__ p = a.p[t];
    const float* __restrict__ g = a.g[t];
    float* __restrict__ mu = a.mu[t];
    float* __restrict__ nu = a.nu[t];
    const int lo = (b - a.begin[t]) * CHUNK, hi = min(a.n[t], lo + CHUNK);
    const float sc = scale != nullptr ? *scale : 1.f;
    for (int base = lo; base < hi; base += THREADS * ILP) {
        float rp[ILP], rg[ILP], rm[ILP], rv[ILP];
#pragma unroll
        for (int k = 0; k < ILP; ++k) {
            const int i = base + k * THREADS + threadIdx.x;
            const bool in = i < hi;
            rp[k] = in ? p[i] : 0.f;
            rg[k] = in && g != nullptr ? g[i] : 0.f;
            rm[k] = in ? mu[i] : 0.f;
            rv[k] = in ? nu[i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < ILP; ++k) {
            const int i = base + k * THREADS + threadIdx.x;
            if (i >= hi) continue;
            float gi = rg[k];
            if (scale != nullptr) gi = __fmul_rn(gi, sc);
            if (s.wd > 0.f) gi = __fadd_rn(gi, __fmul_rn(s.wd, rp[k]));
            const float m = __fadd_rn(__fmul_rn(rm[k], s.b1), __fmul_rn(s.omb1, gi));
            const float v = __fadd_rn(__fmul_rn(rv[k], s.b2), __fmul_rn(s.omb2, __fmul_rn(gi, gi)));
            const float d = __fmul_rn(s.b, __fsqrt_rn(__fdiv_rn(v, s.c2)));
            const float upd = __fmul_rn(s.neg_lr_a, atan2f(__fdiv_rn(m, s.c1), d));
            mu[i] = m;
            nu[i] = v;
            p[i] = __fadd_rn(rp[k], upd);
        }
    }
}

// ---------------------------------------------------------------- Muon

struct MuonArgs {
    static constexpr int MAX = 60;
    float* p[MAX];
    const float* g[MAX];
    float* m[MAX];
    float* u[MAX];              // the matrix's place in the float32 stack
    int rows[MAX];              // the parameter's own layout, row-major
    int cols[MAX];
    int flip[MAX];              // the stack holds the (cols, rows) transpose
    int begin[MAX + 1];         // tiles
    int count;
    int base;                   // the global index of the launch's first tile
};
static_assert(sizeof(MuonArgs) + 16 <= ARG_BYTES, "Muon table over a launch's arguments");

struct NormArgs {
    static constexpr int MAX = 100;
    const float* u[MAX];
    __nv_bfloat16* x[MAX];
    int n[MAX];
    int tile0[MAX];             // the global index of the matrix's first tile
    int tiles[MAX];
    int begin[MAX + 1];         // chunks
    int count;
};
static_assert(sizeof(NormArgs) + 16 <= ARG_BYTES, "normalize table over a launch's arguments");

struct ApplyArgs {
    static constexpr int MAX = 80;
    float* p[MAX];
    const __nv_bfloat16* o[MAX];
    int rows[MAX];
    int cols[MAX];
    int flip[MAX];
    float coef[MAX];
    int begin[MAX + 1];         // tiles
    int count;
};
static_assert(sizeof(ApplyArgs) <= ARG_BYTES, "apply table over a launch's arguments");

struct TileAt {
    int t, r0, c0;
};

__device__ __forceinline__ TileAt tile_at(const int* begin, int count, const int* cols) {
    const int b = blockIdx.x;
    const int t = entry_of(begin, count, b);
    const int tiles_c = (cols[t] + TILE - 1) / TILE;
    const int k = b - begin[t];
    return {t, (k / tiles_c) * TILE, (k % tiles_c) * TILE};
}

// m = mom * m + g; u = mom * m + g (Nesterov), g the clipped and decayed
// gradient. Thread (tx, ty) takes column c0 + tx of rows r0 + ty, ty + 4, ...,
// all its loads issued before it computes.
__global__ void __launch_bounds__(THREADS) muon_momentum(const __grid_constant__ MuonArgs a,
                                                         const float* __restrict__ scale,
                                                         float* __restrict__ partials, float wd,
                                                         float mom) {
    constexpr int PER = TILE / TILE_ROWS;
    __shared__ float tile[TILE][TILE + 1];
    const TileAt at = tile_at(a.begin, a.count, a.cols);
    const int t = at.t, R = a.rows[t], C = a.cols[t];
    const bool flip = a.flip[t] != 0;
    const float* __restrict__ p = a.p[t];
    const float* __restrict__ g = a.g[t];
    float* __restrict__ m = a.m[t];
    float* __restrict__ u = a.u[t];
    const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
    const float sc = scale != nullptr ? *scale : 1.f;
    const int j = at.c0 + tx;
    float rg[PER], rm[PER], rp[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = at.r0 + ty + k * TILE_ROWS;
        const bool in = i < R && j < C;
        const size_t idx = (size_t)i * C + j;
        rg[k] = in && g != nullptr ? g[idx] : 0.f;
        rm[k] = in ? m[idx] : 0.f;
        rp[k] = in && wd > 0.f ? p[idx] : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int rr = ty + k * TILE_ROWS, i = at.r0 + rr;
        if (i >= R || j >= C) continue;
        const size_t idx = (size_t)i * C + j;
        float gi = rg[k];
        if (scale != nullptr) gi = __fmul_rn(gi, sc);
        if (wd > 0.f) gi = __fadd_rn(gi, __fmul_rn(wd, rp[k]));
        const float mm = __fadd_rn(__fmul_rn(rm[k], mom), gi);
        m[idx] = mm;
        const float uu = __fadd_rn(__fmul_rn(mm, mom), gi);
        acc = __fadd_rn(acc, __fmul_rn(uu, uu));
        if (flip) tile[tx][rr] = uu;
        else u[idx] = uu;
    }
    if (flip) {
        __syncthreads();
        // the stack's row j holds column j of the parameter
        const int i = at.r0 + tx;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int cc = ty + k * TILE_ROWS, jj = at.c0 + cc;
            if (jj < C && i < R) u[(size_t)jj * R + i] = tile[cc][tx];
        }
    }
    const float s = block_sum(acc);
    if (threadIdx.x == 0) partials[a.base + blockIdx.x] = s;
}

// x = bf16(u / (sqrt(sum of the matrix's tile sums) + eps)); every block of
// a matrix sums its tiles in the same order, so all get the same norm.
__global__ void __launch_bounds__(THREADS) muon_normalize(const __grid_constant__ NormArgs a,
                                                          const float* __restrict__ partials,
                                                          float eps) {
    __shared__ float denom_s;
    const int b = blockIdx.x;
    const int t = entry_of(a.begin, a.count, b);
    float acc = 0.f;
    for (int i = threadIdx.x; i < a.tiles[t]; i += THREADS) acc = __fadd_rn(acc, partials[a.tile0[t] + i]);
    const float s = block_sum(acc);
    if (threadIdx.x == 0) denom_s = __fadd_rn(__fsqrt_rn(s), eps);
    __syncthreads();
    const float denom = denom_s;
    const float* __restrict__ u = a.u[t];
    __nv_bfloat16* __restrict__ x = a.x[t];
    const int lo = (b - a.begin[t]) * CHUNK, hi = min(a.n[t], lo + CHUNK);
    for (int base = lo; base < hi; base += THREADS * ILP) {
        float r[ILP];
#pragma unroll
        for (int k = 0; k < ILP; ++k) {
            const int i = base + k * THREADS + threadIdx.x;
            r[k] = i < hi ? u[i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < ILP; ++k) {
            const int i = base + k * THREADS + threadIdx.x;
            if (i < hi) x[i] = __float2bfloat16_rn(__fdiv_rn(r[k], denom));
        }
    }
}

// p += coef * o, o the Newton-Schulz output in the stack's orientation
__global__ void __launch_bounds__(THREADS) muon_apply(const __grid_constant__ ApplyArgs a) {
    constexpr int PER = TILE / TILE_ROWS;
    __shared__ float tile[TILE][TILE + 1];
    const TileAt at = tile_at(a.begin, a.count, a.cols);
    const int t = at.t, R = a.rows[t], C = a.cols[t];
    const bool flip = a.flip[t] != 0;
    float* __restrict__ p = a.p[t];
    const __nv_bfloat16* __restrict__ o = a.o[t];
    const float coef = a.coef[t];
    const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
    const int j = at.c0 + tx;
    float rp[PER], ro[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = at.r0 + ty + k * TILE_ROWS;
        const bool in = i < R && j < C;
        const size_t idx = (size_t)i * C + j;
        rp[k] = in ? p[idx] : 0.f;
        ro[k] = in && !flip ? __bfloat162float(o[idx]) : 0.f;
    }
    if (flip) {
        // o is (C, R): rows c0.., columns r0.., kept as tile[column][row]
        const int i = at.r0 + tx;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int cc = ty + k * TILE_ROWS, jj = at.c0 + cc;
            if (jj < C && i < R) tile[cc][tx] = __bfloat162float(o[(size_t)jj * R + i]);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PER; ++k) ro[k] = tile[tx][ty + k * TILE_ROWS];
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int i = at.r0 + ty + k * TILE_ROWS;
        if (i < R && j < C) p[(size_t)i * C + j] = __fadd_rn(rp[k], __fmul_rn(coef, ro[k]));
    }
}

inline int chunks_of(int64_t n) { return (int)((n + CHUNK - 1) / CHUNK); }
inline int tiles_of(int64_t rows, int64_t cols) {
    return (int)(((rows + TILE - 1) / TILE) * ((cols + TILE - 1) / TILE));
}

// the launch count so far, or the negated CUDA error of the launch just made
inline int checked(int launches) {
    const cudaError_t err = cudaGetLastError();
    return err == cudaSuccess ? launches : -(int)err;
}

}  // namespace

// Host entry points. Each takes its table as int64 rows in host memory
// (pointers as integers, a null pointer for a parameter without a gradient),
// launches on `stream` without synchronizing, and returns the number of
// launches it made or, if a launch failed, minus the CUDA error. The tables
// travel in the launches' arguments, so the host memory is free again as soon
// as the call returns and nothing is copied to the device beforehand.

extern "C" int multi_tensor_optim_config(int* chunk, int* tile) {
    *chunk = CHUNK;
    *tile = TILE;
    return 0;
}

// rows [g, n]; partials: one float per chunk of every tensor
extern "C" int multi_tensor_clip_scale(const int64_t* table, int count, float* partials,
                                       float* scale, float max_norm, cudaStream_t stream) {
    int launches = 0, base = 0;
    for (int first = 0; first < count; first += ClipArgs::MAX) {
        ClipArgs a{};
        a.count = count - first < ClipArgs::MAX ? count - first : ClipArgs::MAX;
        a.base = base;
        int chunks = 0;
        for (int j = 0; j < a.count; ++j) {
            const int64_t* row = table + 2 * (first + j);
            a.g[j] = reinterpret_cast<const float*>(row[0]);
            a.n[j] = (int)row[1];
            a.begin[j] = chunks;
            chunks += chunks_of(row[1]);
        }
        a.begin[a.count] = chunks;
        if (chunks > 0) {
            clip_partials<<<chunks, THREADS, 0, stream>>>(a, partials);
            if ((launches = checked(launches + 1)) < 0) return launches;
        }
        base += chunks;
    }
    clip_final<<<1, THREADS, 0, stream>>>(partials, base, max_norm, scale);
    return checked(launches + 1);
}

// rows [p, g, mu, nu, n]; scale null: no clip
extern "C" int multi_tensor_adam_atan2(const int64_t* table, int count, const float* scale,
                                       float wd, float b1, float omb1, float b2, float omb2,
                                       float c1, float c2, float b, float neg_lr_a,
                                       cudaStream_t stream) {
    const AdamScalars s{wd, b1, omb1, b2, omb2, c1, c2, b, neg_lr_a};
    int launches = 0;
    for (int first = 0; first < count; first += AdamArgs::MAX) {
        AdamArgs a{};
        a.count = count - first < AdamArgs::MAX ? count - first : AdamArgs::MAX;
        int chunks = 0;
        for (int j = 0; j < a.count; ++j) {
            const int64_t* row = table + 5 * (first + j);
            a.p[j] = reinterpret_cast<float*>(row[0]);
            a.g[j] = reinterpret_cast<const float*>(row[1]);
            a.mu[j] = reinterpret_cast<float*>(row[2]);
            a.nu[j] = reinterpret_cast<float*>(row[3]);
            a.n[j] = (int)row[4];
            a.begin[j] = chunks;
            chunks += chunks_of(row[4]);
        }
        a.begin[a.count] = chunks;
        if (chunks == 0) continue;
        adam_atan2<<<chunks, THREADS, 0, stream>>>(a, scale, s);
        if ((launches = checked(launches + 1)) < 0) return launches;
    }
    return launches;
}

// rows [p, g, m, u, x, rows, cols, flip]; partials: one float per tile of
// every matrix; scale null: no clip
extern "C" int multi_tensor_muon_prepare(const int64_t* table, int count, const float* scale,
                                         float* partials, float wd, float mom, float eps,
                                         cudaStream_t stream) {
    int launches = 0, base = 0;
    for (int first = 0; first < count; first += MuonArgs::MAX) {
        MuonArgs a{};
        a.count = count - first < MuonArgs::MAX ? count - first : MuonArgs::MAX;
        a.base = base;
        int tiles = 0;
        for (int j = 0; j < a.count; ++j) {
            const int64_t* row = table + 8 * (first + j);
            a.p[j] = reinterpret_cast<float*>(row[0]);
            a.g[j] = reinterpret_cast<const float*>(row[1]);
            a.m[j] = reinterpret_cast<float*>(row[2]);
            a.u[j] = reinterpret_cast<float*>(row[3]);
            a.rows[j] = (int)row[5];
            a.cols[j] = (int)row[6];
            a.flip[j] = (int)row[7];
            a.begin[j] = tiles;
            tiles += tiles_of(row[5], row[6]);
        }
        a.begin[a.count] = tiles;
        if (tiles > 0) {
            muon_momentum<<<tiles, THREADS, 0, stream>>>(a, scale, partials, wd, mom);
            if ((launches = checked(launches + 1)) < 0) return launches;
        }
        base += tiles;
    }
    int tile0 = 0;
    for (int first = 0; first < count; first += NormArgs::MAX) {
        NormArgs a{};
        a.count = count - first < NormArgs::MAX ? count - first : NormArgs::MAX;
        int chunks = 0;
        for (int j = 0; j < a.count; ++j) {
            const int64_t* row = table + 8 * (first + j);
            a.u[j] = reinterpret_cast<const float*>(row[3]);
            a.x[j] = reinterpret_cast<__nv_bfloat16*>(row[4]);
            a.n[j] = (int)(row[5] * row[6]);
            a.tile0[j] = tile0;
            a.tiles[j] = tiles_of(row[5], row[6]);
            tile0 += a.tiles[j];
            a.begin[j] = chunks;
            chunks += chunks_of(row[5] * row[6]);
        }
        a.begin[a.count] = chunks;
        if (chunks == 0) continue;
        muon_normalize<<<chunks, THREADS, 0, stream>>>(a, partials, eps);
        if ((launches = checked(launches + 1)) < 0) return launches;
    }
    return launches;
}

// rows [p, o, rows, cols, flip], coefs one float per row
extern "C" int multi_tensor_muon_apply(const int64_t* table, const float* coefs, int count,
                                       cudaStream_t stream) {
    int launches = 0;
    for (int first = 0; first < count; first += ApplyArgs::MAX) {
        ApplyArgs a{};
        a.count = count - first < ApplyArgs::MAX ? count - first : ApplyArgs::MAX;
        int tiles = 0;
        for (int j = 0; j < a.count; ++j) {
            const int64_t* row = table + 5 * (first + j);
            a.p[j] = reinterpret_cast<float*>(row[0]);
            a.o[j] = reinterpret_cast<const __nv_bfloat16*>(row[1]);
            a.rows[j] = (int)row[2];
            a.cols[j] = (int)row[3];
            a.flip[j] = (int)row[4];
            a.coef[j] = coefs[first + j];
            a.begin[j] = tiles;
            tiles += tiles_of(row[2], row[3]);
        }
        a.begin[a.count] = tiles;
        if (tiles == 0) continue;
        muon_apply<<<tiles, THREADS, 0, stream>>>(a);
        if ((launches = checked(launches + 1)) < 0) return launches;
    }
    return launches;
}
