// Shared pieces of the port's small-attention kernels (K4 forward, K5
// backward): the item ring fed by bulk-async copies, the mask as per-row
// bits, the fragment loads and stores at a runtime row stride, the build
// option for measuring (SA_TRACE), and the persistent launch.
// The softclamp and the bf16 tensor-core fragments are those of the flash
// kernels (flash_attn_common.cuh), the mbarriers those of
// flash_attn_sm90.cuh, so both families round, clamp and wait alike.
//
// Layout: q, k, v, o (and dO, dq, dk, dv) are (B, n*h, D), contiguous; row
// i*h + hh holds token i of head hh. An item is one batch row and a group of
// G consecutive heads g0 .. g0 + G - 1: for each token, the G heads' rows
// are G*D contiguous elements in device memory, and one `cp.async.bulk`
// copies them into one row of a staged tile. A tile holds NPAD rows (n
// padded to 16, 32 or 64) of LD = G*D + 16 bytes' worth of elements: head
// hh's rows are the columns hh*D .. hh*D + D - 1, and the 16-byte pad makes
// the row stride an odd multiple of 16 bytes, so the 8 rows that one
// `ldmatrix` or fragment load touches fall in 8 different bank groups.
// Rows >= n are never copied: they are zero-filled when the block starts and
// stay zero, since n is fixed within a call.
//
// Block: warp 0 is the producer, warps 1 .. C consume. The producer walks
// the block's items (blockIdx.x, + gridDim.x, ...) through a ring of
// `stages` tile sets: it waits until the consumers released a stage
// (`empty`), announces the item's bytes on `full` and issues its row copies.
// Consumers wait on `full`, compute, and release the stage as soon as they
// have read their last of it. K4 and the float32 kernels store their
// outputs from registers; K5 in bf16 writes its gradients into output
// tiles of the same row layout after the ring (`stmatrix`, one tile per
// gradient, not staged) and sends them out as `cp.async.bulk`
// shared-to-global row copies; a warp waits for those copies to have read
// its rows only when it writes them again, an item later. Where every
// block takes one item at most, nothing follows a store to hide it behind,
// and K5 stores from registers too, without the output tiles
// (Params::direct_out). (On the card each was the faster choice where it
// is taken: PERF.md §6.)
//
// The grid is persistent: min(items, the blocks the card holds at once),
// the occupancy queried once per kernel configuration and cached.

#pragma once

#include <map>
#include <mutex>
#include <tuple>

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace sa {

using fa::bf16;

// consumer warps a block may have: the kernels are compiled for
// 32 * (1 + MAX_CONSUMER_WARPS) threads (ops/small_attention.py mirrors it)
constexpr int MAX_CONSUMER_WARPS = 8;
constexpr int MAX_THREADS = 32 * (1 + MAX_CONSUMER_WARPS);
constexpr int BARRIER_BYTES = 128;     // the ring's mbarriers, before the tiles
constexpr int MAX_SMEM_BYTES = 232448;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;              // K5 only
    const uint8_t* mask;           // (n, n), 1 = may attend; null: no mask
    void* o;                       // K4: o; K5: dq
    void* dk;                      // K5 only
    void* dv;                      // K5 only
    int n, h;
    int G;                         // heads per item
    int groups;                    // h / G
    int items;                     // B * groups
    int stages;                    // tile sets in the ring
    int direct_out;                // K5 in bf16: gradients stored from the fragments
    fa::MaskParams clamp;          // scale and softclamp, as the flash kernels take them
};

// padded keys (kj >= n) get this score: exp of it is exactly 0, so they
// never enter a softmax, a sum or a gradient
__device__ __forceinline__ float pad_score() { return __int_as_float(0xff800000); }   // -inf

// Elements per staged row: G heads of D, then 16 bytes of pad.
template <typename T>
__host__ __device__ __forceinline__ int row_elems(int G, int D) {
    return G * D + 16 / (int)sizeof(T);
}

// Bytes of one stage: `tensors` tiles of NPAD rows.
template <typename T>
__host__ __device__ __forceinline__ size_t stage_bytes(int tensors, int npad, int G, int D) {
    return (size_t)tensors * npad * row_elems<T>(G, D) * sizeof(T);
}

// --------------------------------------------------------------- the ring

struct Ring {
    uint64_t* full;     // [stages]: the producer's arrival and the item's bytes
    uint64_t* empty;    // [stages]: one arrival per consumer warp
    uint8_t* tiles;     // stage s at tiles + s * stage; after_ring's slots after the last
    size_t stage;       // bytes per stage
    size_t tile;        // bytes per tensor tile
    int ld;             // elements per row
};

template <typename T>
__device__ __forceinline__ Ring make_ring(uint8_t* smem, const Params& p, int tensors, int npad,
                                          int D) {
    Ring r;
    r.full = reinterpret_cast<uint64_t*>(smem);
    r.empty = r.full + p.stages;
    r.tiles = smem + BARRIER_BYTES;
    r.ld = row_elems<T>(p.G, D);
    r.tile = (size_t)npad * r.ld * sizeof(T);
    r.stage = r.tile * tensors;
    return r;
}

template <typename T>
__device__ __forceinline__ T* tile_of(const Ring& r, int stage, int tensor) {
    return reinterpret_cast<T*>(r.tiles + stage * r.stage + tensor * r.tile);
}

// the i-th tile-sized slot after the ring's stages (K5's output tiles, then
// the p and ds tiles; K4's float32 probability tiles)
template <typename T>
__device__ __forceinline__ T* after_ring(const Ring& r, const Params& p, int i) {
    return tile_of<T>(r, p.stages, i);
}

// Block start: the mbarriers initialised, then a barrier of the whole
// block, so that the producer may start its copies at once.
__device__ __forceinline__ void ring_init(const Ring& r, const Params& p, int consumer_warps) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < p.stages; ++s) {
            sm90::mbar_init(&r.full[s], 1);
            sm90::mbar_init(&r.empty[s], consumer_warps);
        }
        sm90::fence_barrier_init();
    }
    __syncthreads();
}

// The consumers' start: rows n .. npad - 1 of every tile of every stage (a
// contiguous range of each tile) zeroed while the producer's first copies
// fill rows 0 .. n - 1, then a barrier of the consumer warps (id 15; the
// heads' barriers take 1 .. 8). Nothing where n fills its tiles.
template <typename T>
__device__ __forceinline__ void zero_padding(const Ring& r, const Params& p, int tensors,
                                             int consumer_warps) {
    const size_t first = (size_t)p.n * r.ld * sizeof(T);
    const int chunks = (int)((r.tile - first) / 16);
    if (chunks == 0) return;
    const int threads = 32 * consumer_warps;
    for (int t = 0; t < p.stages * tensors; ++t) {
        uint4* pad = reinterpret_cast<uint4*>(r.tiles + t * r.tile + first);
        for (int c = (int)threadIdx.x - 32; c < chunks; c += threads) {
            pad[c] = make_uint4(0u, 0u, 0u, 0u);
        }
    }
    sm90::named_barrier_sync(15, threads);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(sm90::smem_u32(dst)), "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(dst), "r"(sm90::smem_u32(src)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk stores have read their shared-memory source:
// a block ends only then, and need not wait for the writes themselves
__device__ __forceinline__ void bulk_wait_read_all() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's ordinary shared-memory writes before later
// bulk-async copies that read them
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The producer warp: every item of this block into the ring, `tensors`
// inputs of D-element rows (global base pointers in `src`).
template <typename T, int D>
__device__ __forceinline__ void produce(const Ring& r, const Params& p, const void* const* src,
                                        int tensors) {
    const int lane = threadIdx.x & 31;
    const uint32_t row_bytes = (uint32_t)(p.G * D * sizeof(T));
    int j = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++j) {
        const int s = j % p.stages;
        if (j >= p.stages) sm90::mbar_wait(&r.empty[s], (j / p.stages - 1) & 1);
        const int b = item / p.groups;
        const int g0 = (item % p.groups) * p.G;
        if (lane == 0) sm90::mbar_expect_tx(&r.full[s], row_bytes * p.n * tensors);
        __syncwarp();
        for (int c = lane; c < tensors * p.n; c += 32) {
            const int t = c / p.n;
            const int row = c % p.n;
            const T* from =
                static_cast<const T*>(src[t]) + ((size_t)(b * p.n + row) * p.h + g0) * D;
            bulk_load(tile_of<T>(r, s, t) + row * r.ld, from, row_bytes, &r.full[s]);
        }
    }
}

// The offset in elements of token `row`, head hh of the item's batch row b
// in the flat (B, n*h, D) layout.
template <int D>
__device__ __forceinline__ size_t flat_row(int item, int row, int hl, const Params& p) {
    const int b = item / p.groups;
    const int hh = (item % p.groups) * p.G + hl;
    return ((size_t)(b * p.n + row) * p.h + hh) * D;
}

// A consumer warp's release of a stage once it has read its last of it.
__device__ __forceinline__ void release(const Ring& r, int stage) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sm90::mbar_arrive(&r.empty[stage]);
}

// Before a warp writes its rows of an output tile again: the bulk stores it
// issued from there (an item ago) have read them, all but the `pending`
// newest bulk groups of each lane being done reading.
template <int pending>
__device__ __forceinline__ void await_out_tile() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(pending) : "memory");
    __syncwarp();
}

// barrier of the `warps` warps of one head (id 1 + head; 0 is __syncthreads)
__device__ __forceinline__ void head_barrier(int head, int warps) {
    if (warps == 1) {
        __syncwarp();
    } else {
        sm90::named_barrier_sync(1 + head, 32 * warps);
    }
}

// A build option for measuring: with SA_TRACE, lane 0 of each block's first
// consumer warp records clock64() since its start at points of its walk
// (slot 0: the globaltimer at its start; 1: the mask read; 2 + 3j, 3 + 3j,
// 4 + 3j: item j < 4 arrived, released (K5: its dq out), stored; 15: the
// end), which the entry point SA_TRACE_ENTRY declares copies to the host.
#ifdef SA_TRACE
__device__ unsigned long long sa_trace[8192][16];
#define SA_TRACE_START()                                                             \
    const long long sa_t0 = clock64();                                               \
    if (threadIdx.x == 32 && blockIdx.x < 8192) {                                    \
        unsigned long long g;                                                        \
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));                        \
        sa_trace[blockIdx.x][0] = g;                                                 \
    }
#define SA_STAMP(slot)                                                               \
    if (threadIdx.x == 32 && blockIdx.x < 8192 && (slot) < 16)                       \
        sa_trace[blockIdx.x][(slot) < 15 ? (slot) : 15] = clock64() - sa_t0;
#else
#define SA_TRACE_START()
#define SA_STAMP(slot)
#endif
#ifdef SA_TRACE
#define SA_TRACE_ENTRY(name)                                                         \
    extern "C" int name(void* out) {                                                 \
        return (int)cudaMemcpyFromSymbol(out, sa::sa_trace, sizeof(sa::sa_trace));   \
    }
#else
#define SA_TRACE_ENTRY(name)
#endif

// ---------------------------------------------------------------- the mask

// The (n, n) mask as bits (bit kj: may attend to key kj) of the lane's
// rows row0 + lane / 4 + 8 r, r < R, the rows a lane holds in the score
// fragments: 0 for a padded row, every key < n without a mask. The warp
// reads its 8 R rows at once with coalesced byte loads (lane l: keys l and
// 32 + l), all issued before the first ballot, so the table costs one
// load latency at the block's start, hidden behind the first item's copies.
template <int R>
__device__ __forceinline__ void lane_mask_bits(uint64_t (&bits)[R], int row0, const Params& p) {
    const int lane = threadIdx.x & 31;
    uint32_t lo[8 * R], hi[8 * R];
#pragma unroll
    for (int i = 0; i < 8 * R; ++i) {
        const int row = row0 + i;
        const bool in = p.mask != nullptr && row < p.n;
        lo[i] = in && lane < p.n ? p.mask[row * p.n + lane] : 0u;
        hi[i] = in && lane + 32 < p.n ? p.mask[row * p.n + lane + 32] : 0u;
    }
    const uint64_t all = p.n == 64 ? ~0ull : ((1ull << p.n) - 1ull);
#pragma unroll
    for (int i = 0; i < 8 * R; ++i) {
        uint64_t b = ((uint64_t)__ballot_sync(0xffffffffu, hi[i] != 0u) << 32) |
                     __ballot_sync(0xffffffffu, lo[i] != 0u);
        if (p.mask == nullptr) b = all;
        if (row0 + i >= p.n) b = 0ull;
        if ((i & 7) == (lane >> 2)) bits[i >> 3] = b;
    }
}

// The score of the thread's key c0 + col from the raw dot product: padded
// keys excluded, then scale and softclamp, then the mask (the TPU kernel's
// order). `bits` is the mask row shifted right by c0 and `keys` = n - c0,
// so that `col`, a constant of the unrolled loops, selects with constant
// shifts. Written without branches, the softclamp computed and then chosen
// (as fa::clamp_score computes it), so that the unrolled loops interleave
// the exponentials of all their keys. dscore: the softclamp's derivative
// 1 - tanh^2 (1 without one, 0 for a padded key).
__device__ __forceinline__ float small_score(float dot, int col, uint64_t bits, int keys,
                                             const Params& p, float& dscore) {
    const float e = fa::exp2_approx(fminf(fmaxf(dot * p.clamp.tanh_k, -43.f), 43.f));
    const float t = 1.f - __fdividef(2.f, e + 1.f);
    const bool clamp = p.clamp.softclamp > 0.f;
    const float x = clamp ? p.clamp.softclamp * t : dot * p.clamp.scale;
    const bool pad = col >= keys;
    dscore = pad ? 0.f : clamp ? 1.f - t * t : 1.f;
    return pad ? pad_score() : (bits >> col) & 1ull ? x : fa::NEG_INF;
}

// ------------------------------------------------- fragments at a stride

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* ptr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(sm90::smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* ptr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(sm90::smem_u32(ptr)));
}

// The A fragment of fa::load_a_frag (rows row0 .. row0 + 15, columns k0 ..
// k0 + 15 of a tile with row stride ld) by one `ldmatrix.x4`: its four 8 x 8
// matrices are rows +0 / +8 at columns +0, then +0 / +8 at columns +8.
__device__ __forceinline__ void ldsm_a_frag(uint32_t (&a)[4], const bf16* tile, int ld, int row0,
                                            int k0) {
    const int lane = threadIdx.x & 31;
    ldmatrix_x4(a, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 + (lane >> 4) * 8);
}

// The B fragments of fa::load_b_frag for rows col0 .. col0 + 7 (b[0], b[1]) and
// col0 + 8 .. col0 + 15 (b[2], b[3]) by one `ldmatrix.x4`.
__device__ __forceinline__ void ldsm_b_frags(uint32_t (&b)[4], const bf16* tile, int ld, int col0,
                                             int k0) {
    const int lane = threadIdx.x & 31;
    ldmatrix_x4(b, tile + (col0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The B fragments of a row-major [k][n] tile's rows k0 .. k0 + 15 at
// columns c0 .. c0 + 7 (b[0], b[1]) and c0 + 8 .. c0 + 15 (b[2], b[3]), as
// fa::ldmatrix_x2_trans gives one, by one `ldmatrix.x4.trans`.
__device__ __forceinline__ void ldsm_bt_frags(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                              int c0) {
    const int lane = threadIdx.x & 31;
    ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// c0 += a . (b[0], b[1]) and c1 += a . (b[2], b[3]): the two B fragments
// one ldsm_b_frags / ldsm_bt_frags gives
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[4]) {
    const uint32_t lo[2] = {b[0], b[1]};
    const uint32_t hi[2] = {b[2], b[3]};
    fa::mma_16816(c0, a, lo);
    fa::mma_16816(c1, a, hi);
}

__device__ __forceinline__ void stmatrix_x4(bf16* ptr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
                 ::"r"(sm90::smem_u32(ptr)), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                 : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(bf16* ptr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
                 ::"r"(sm90::smem_u32(ptr)), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
                 : "memory");
}

// The warp's 16 x (8 NB) float accumulators (acc[nb][2r + e]: row
// row0 + g + 8r, column 8nb + 2t + e) as bf16 into rows row0 .. of a tile
// with row stride ld; rows >= valid_rows are left as they are. A whole
// 16-row block goes by `stmatrix`, a ragged one row by row.
template <int NB>
__device__ __forceinline__ void store_rows(bf16* tile, int ld, int row0, int valid_rows,
                                           const float (&acc)[NB][4]) {
    const int lane = threadIdx.x & 31;
    if (row0 + 16 <= valid_rows) {
        const int j = lane >> 3;
        bf16* dst = tile + (row0 + (j & 1) * 8 + (lane & 7)) * ld + (j >> 1) * 8;
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
            stmatrix_x4(dst + nb * 8, fa::pack_bf16x2(acc[nb][0], acc[nb][1]),
                        fa::pack_bf16x2(acc[nb][2], acc[nb][3]),
                        fa::pack_bf16x2(acc[nb + 1][0], acc[nb + 1][1]),
                        fa::pack_bf16x2(acc[nb + 1][2], acc[nb + 1][3]));
        }
        return;
    }
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row >= valid_rows) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            *reinterpret_cast<uint32_t*>(tile + row * ld + nb * 8 + 2 * t) =
                fa::pack_bf16x2(acc[nb][2 * r], acc[nb][2 * r + 1]);
        }
    }
}

// The warp's 16 x (8 NB) float accumulators (acc[nb][2r + e]: row
// row0 + g + 8r, column 8nb + 2t + e) as bf16 straight to the flat layout,
// rows >= n left out: each lane stores 4 bytes of each of its 2 rows per
// 8-column block.
template <int D, int NB>
__device__ __forceinline__ void store_frags(void* out, int item, int row0, int hl,
                                            const Params& p, const float (&acc)[NB][4]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + (lane >> 2) + 8 * r;
        if (row >= p.n) continue;
        bf16* dst = static_cast<bf16*>(out) + flat_row<D>(item, row, hl, p) + 2 * (lane & 3);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            *reinterpret_cast<uint32_t*>(dst + nb * 8) =
                fa::pack_bf16x2(acc[nb][2 * r], acc[nb][2 * r + 1]);
        }
    }
}

// The warp's 16 rows of one of K5's gradients from its accumulators to the
// flat layout: with p.direct_out by store_frags; else through its rows of
// the output tile (`stmatrix`) and one `cp.async.bulk` per row, which the
// caller commits as a bulk group.
template <int D, int NB>
__device__ __forceinline__ void write_rows(void* out, bf16* tile, int ld, int item, int row0,
                                           int hl, const Params& p, const float (&acc)[NB][4]) {
    if (p.direct_out) {
        store_frags<D>(out, item, row0, hl, p, acc);
        return;
    }
    store_rows(tile, ld, row0, p.n, acc);
    fence_async_smem();
    __syncwarp();
    const int lane = threadIdx.x & 31;
    const int row = row0 + lane;
    if (lane < 16 && row < p.n) {
        bulk_store(static_cast<bf16*>(out) + flat_row<D>(item, row, hl, p), tile + row * ld,
                   D * sizeof(bf16));
    }
}

// ------------------------------------------------------------ host side

// Blocks of `kernel` that the card holds at once at `threads` threads and
// `smem` bytes of dynamic shared memory (blocks per SM x SMs), queried once
// per (device, kernel, threads, smem); the kernel's shared-memory limit is
// raised to the card's on first use.
inline int resident_blocks(const void* kernel, int threads, size_t smem) {
    static std::mutex mu;
    static std::map<std::tuple<int, const void*, int, size_t>, int> cache;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    const auto key = std::make_tuple(dev, kernel, threads, smem);
    std::lock_guard<std::mutex> lock(mu);
    const auto hit = cache.find(key);
    if (hit != cache.end()) return hit->second;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM_BYTES) != cudaSuccess) {
        return 0;
    }
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
        return 0;
    }
    cache[key] = per_sm * sms;
    return per_sm * sms;
}

// One launch of a persistent kernel: min(items, the blocks that fit at
// once) blocks. With `resident_out`, nothing is launched: it receives the
// blocks that fit at once.
template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, int threads, size_t smem, const Params& p,
                              cudaStream_t stream, int* resident_out) {
    if (threads > MAX_THREADS || smem > (size_t)MAX_SMEM_BYTES) return cudaErrorInvalidValue;
    const int resident = resident_blocks(reinterpret_cast<const void*>(kernel), threads, smem);
    if (resident <= 0) return cudaErrorInvalidConfiguration;
    if (resident_out != nullptr) {
        *resident_out = resident;
        return cudaSuccess;
    }
    const int blocks = p.items < resident ? p.items : resident;
    kernel<<<blocks, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

inline bool make_params(Params& p, int B, int n, int h, int G, int stages, float scale,
                        float softclamp) {
    if (B <= 0 || n <= 0 || n > 64 || h <= 0 || G <= 0 || h % G != 0 || stages <= 0) return false;
    if ((long long)B * h > 0x7fffffffLL) return false;
    p = Params{};
    p.n = n;
    p.h = h;
    p.G = G;
    p.groups = h / G;
    p.items = B * p.groups;
    p.stages = stages;
    p.clamp = fa::make_mask_params(n, n, 0, n, scale, softclamp, 0, 0, 0, 0);
    return (size_t)2 * stages * sizeof(uint64_t) <= (size_t)BARRIER_BYTES;
}

}  // namespace sa
