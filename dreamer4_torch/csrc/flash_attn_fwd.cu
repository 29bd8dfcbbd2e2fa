// Flash-attention forward for Hopper (sm_90a): K1 of the port.
//
// Replaces the Pallas TPU kernel `_attn_kernel` (host `flash_attend_fwd`) in
// dreamer4_tpu/ops/flash_attention.py. It computes the same function:
//
//   s   = (q . k) * scale                      float32
//   s   = tanh(s / c) * c                       when a softclamp c is given
//   s   = mask ? s : -1e30                      mask from indices, see below
//   o   = softmax(s) . v                        online softmax in float32
//   lse = m + log(l)                            optional, float32
//
// The mask is the family of `_mask_block`: key k is valid when k < kv_len;
// causal adds k <= q + offset; with num_special > 0 special tokens sit at
// the right of every special_seq_len block, in either direction, with the
// query position taken as (q + offset) mod special_seq_len. Query head h
// reads kv head h / groups (grouped-query attention).
//
// Layout: q, o (B, Hq, N, D); k, v (B, H, M, D); lse (B, Hq, N); all
// contiguous. D is 16, 32, 64 or 128; the element type is float32 or bf16.
// Tiles wholly beyond kv_len or above the causal diagonal are never loaded;
// ragged N and M edges are masked inside the kernel. As in the TPU kernel,
// the probabilities are rounded to the input type before the PV product and
// the row sum uses them unrounded. The TPU kernel's blocking (128-lane LSE
// padding, D padded to 128) is not carried over. Three kernels, chosen by
// the caller (`k1_variant` in ops/flash_attention.py):
//
// sm90: bf16, head dims 64 and 128, any N down to a single query:
//   `flash_fwd_sm90`. One block per (q tile of 64 rows, q head, batch), three
//   blocks per SM, three ring stages, as measured on an H100 (PERF.md): two
//   consumer warpgroups per block fit two blocks per SM only at 96
//   registers, where ptxas spills and serializes the wgmma pipeline.
//   - One producer warp loads the block's q tile once, then the k and v
//     tiles of 64 rows by TMA (cp.async.bulk.tensor) through a ring of STAGES
//     stages with full and empty mbarriers. The k/v tensor maps end at
//     min(kv_len, M), so TMA writes zeros for the rows past it and a NaN in
//     an unused cache row cannot reach O; tiles no query of the block sees
//     are never requested.
//   - One consumer warpgroup (4 warps, 16 query rows each) on `wgmma`:
//     S = Q K^T with both operands K-major in shared memory; the softclamp,
//     the mask and the online softmax (log2 units, log2(e) folded into one
//     constant) on the accumulator registers; O += P V with P re-packed to
//     bf16 as the register A operand and the v tile as the MN-major B
//     operand. Tile i's
//     S is issued together with P V of tile i - 1, so the exponentials of
//     tile i run while the tensor cores work on that product; p stays in
//     the float32 score registers until the product completed and is
//     packed to bf16 only then (rewriting the A operand of an in-flight
//     wgmma makes ptxas serialize the pipeline). Registers at D = 64: S 32,
//     O 32, P 16, held to 128 (three blocks per SM).
//   - Tiles wholly inside the visible region skip the predicate (also with
//     special tokens, where the tile holds no special row or column that
//     loses a pair); the others take each column's special flag once per
//     tile. Each thread keeps its share of the row sums and reduces them
//     across its row's four lanes once, at the end. Blocks run the longest
//     causal walk of each head first (the q tile index counts down).
// mma: bf16, any head dim (head dims 16/32 on the port's path):
//   `flash_fwd_bf16`, four warps, 16 query rows each, on
//   `mma.sync.m16n8k16`. Q stays in registers as A fragments; the score
//   accumulators are reused as the A fragments of the PV product; V's B
//   fragments come from the row-major tile through `ldmatrix.trans`; plain
//   16-byte loads without a copy pipeline.
// f32: `flash_fwd_f32`, 256 threads on the float32 cores, four threads per
//   query row, the tiles staged as float32 (the tensor cores have no float32
//   mode that keeps the reference's precision).
//
// Bounds. At the train step's time attention (B=27, H=8, N=M=1024, D=64,
// bf16, causal, softclamp 50; 113.4M visible pairs): bytes 0.034 ms at
// 3.35 TB/s, tensor work (4 D operations per pair) 0.029 ms at 989 TFLOP/s,
// 2 transcendentals per pair (tanh, exp) 0.054 ms on the exponential unit
// (16 per clock per SM x 132 SMs x 1.98 GHz): the exponential unit binds.
// As the kernel computes it, the softclamp costs an exponential and a
// reciprocal and the diagonal tiles evaluate their masked halves: 3 x 120.3M
// special-function operations, 0.086 ms, the floor of this design. At the
// rollout's prefill (B=432, H=8, N=96, M=192, kv_len=96) bytes bind: 170 MB,
// 0.051 ms.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace {

using namespace fa;

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // kv rows per tile

struct Params : MaskParams {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;                    // null: no LSE
    int Hq, H;
};

// ------------------------------------------------------------------ float32

constexpr int F32_THREADS = 256;   // 4 threads per query row
constexpr int F32_COLS = BK / 4;   // scores per thread per tile

template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_f32(const Params p) {
    constexpr int LD = D + 4;        // padded row stride of q/k/v tiles
    constexpr int LDP = BK + 4;      // padded row stride of the probability tile
    constexpr int DC = D / 4;        // output columns per thread

    extern __shared__ float smem[];
    float* qs = smem;                    // BQ x LD
    float* ks = qs + BQ * LD;            // BK x LD
    float* vs = ks + BK * LD;            // BK x LD
    float* ps = vs + BK * LD;            // BQ x LDP

    const int q_start = blockIdx.x * BQ;
    const int hq = blockIdx.y;
    const int b = blockIdx.z;
    const int h = hq / (p.Hq / p.H);
    const int row = threadIdx.x >> 2;    // query row inside the tile
    const int quad = threadIdx.x & 3;    // which quarter of the row
    const int qi = q_start + row;        // absolute query index

    const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.Hq + hq) * p.N * D
                      + (size_t)q_start * D;
    const float* kb = static_cast<const float*>(p.k) + ((size_t)b * p.H + h) * p.M * D;
    const float* vb = static_cast<const float*>(p.v) + ((size_t)b * p.H + h) * p.M * D;

    load_f32_tile<D, LD, F32_THREADS>(qs, qb, BQ, min(BQ, p.N - q_start));
    const bool q_special = p.num_special > 0 && is_special(qi + p.offset, p);

    float m_run = NEG_INF;
    float l_run = 0.f;
    float acc[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[j] = 0.f;

    const int k_end = kv_end(q_start, BQ, p);
    for (int k_start = 0; k_start < k_end; k_start += BK) {
        const int valid_k = min(BK, k_end - k_start);
        __syncthreads();   // previous tile's ks/vs/ps fully consumed
        load_f32_tile<D, LD, F32_THREADS>(ks, kb + (size_t)k_start * D, BK, valid_k);
        load_f32_tile<D, LD, F32_THREADS>(vs, vb + (size_t)k_start * D, BK, valid_k);
        __syncthreads();

        // scores for columns quad + 4 * j
        float s[F32_COLS];
#pragma unroll
        for (int j = 0; j < F32_COLS; ++j) s[j] = 0.f;
        const float* qrow = qs + row * LD;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
            for (int j = 0; j < F32_COLS; ++j) {
                const float4 kv4 = *reinterpret_cast<const float4*>(ks + (quad + 4 * j) * LD + d);
                s[j] = fmaf(qv.x, kv4.x, s[j]);
                s[j] = fmaf(qv.y, kv4.y, s[j]);
                s[j] = fmaf(qv.z, kv4.z, s[j]);
                s[j] = fmaf(qv.w, kv4.w, s[j]);
            }
        }

        float tile_max = NEG_INF;
#pragma unroll
        for (int j = 0; j < F32_COLS; ++j) {
            s[j] = masked_score(s[j], qi, q_special, k_start + quad + 4 * j, p);
            tile_max = fmaxf(tile_max, s[j]);
        }
        // the four threads of a row are adjacent lanes of one warp
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));

        const float m_new = fmaxf(m_run, tile_max);
        const float alpha = __expf(m_run - m_new);
        float p_sum = 0.f;
        float* prow = ps + row * LDP;
#pragma unroll
        for (int j = 0; j < F32_COLS; ++j) {
            const float pj = __expf(s[j] - m_new);
            p_sum += pj;
            prow[quad + 4 * j] = pj;
        }
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
        l_run = l_run * alpha + p_sum;
        m_run = m_new;
        __syncthreads();   // the row's probabilities are written by 4 threads

        // acc[c] covers output columns 4 * quad + 16 * (c / 4) + c % 4
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[j] *= alpha;
        for (int c = 0; c < BK; ++c) {
            const float pc = prow[c];
            const float* vrow = vs + c * LD + 4 * quad;
#pragma unroll
            for (int j = 0; j < DC / 4; ++j) {
                const float4 v4 = *reinterpret_cast<const float4*>(vrow + 16 * j);
                acc[4 * j + 0] = fmaf(pc, v4.x, acc[4 * j + 0]);
                acc[4 * j + 1] = fmaf(pc, v4.y, acc[4 * j + 1]);
                acc[4 * j + 2] = fmaf(pc, v4.z, acc[4 * j + 2]);
                acc[4 * j + 3] = fmaf(pc, v4.w, acc[4 * j + 3]);
            }
        }
    }

    if (qi < p.N) {
        const float l = fmaxf(l_run, 1e-30f);
        float* orow = static_cast<float*>(p.o) + (((size_t)b * p.Hq + hq) * p.N + qi) * D;
#pragma unroll
        for (int j = 0; j < DC / 4; ++j) {
            const float4 out = make_float4(acc[4 * j] / l, acc[4 * j + 1] / l,
                                           acc[4 * j + 2] / l, acc[4 * j + 3] / l);
            *reinterpret_cast<float4*>(orow + 4 * quad + 16 * j) = out;
        }
        if (p.lse != nullptr && quad == 0) {
            p.lse[((size_t)b * p.Hq + hq) * p.N + qi] = m_run + logf(l);
        }
    }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
    constexpr int LD = D + 4;
    constexpr int LDP = BK + 4;
    const size_t smem = sizeof(float) * ((size_t)BQ * LD + 2 * (size_t)BK * LD + (size_t)BQ * LDP);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BQ - 1) / BQ, p.Hq, B);
    flash_fwd_f32<D><<<grid, F32_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// --------------------------------------------------------------------- bf16

constexpr int BF16_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
__global__ void __launch_bounds__(BF16_THREADS) flash_fwd_bf16(const Params p) {
    constexpr int LD = D + 8;        // bf16 row stride of the tiles (16-byte pad: no bank conflicts)
    constexpr int KSTEPS = D / 16;   // mma k-steps over the head dim
    constexpr int NB_S = BK / 8;     // 8-key column blocks of a score tile
    constexpr int NB_O = D / 8;      // 8-column blocks of the output

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
    bf16* ks = qs + BQ * LD;                        // BK x LD
    bf16* vs = ks + BK * LD;                        // BK x LD

    const int q_start = blockIdx.x * BQ;
    const int hq = blockIdx.y;
    const int b = blockIdx.z;
    const int h = hq / (p.Hq / p.H);
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;                          // fragment row group
    const int t = lane & 3;                           // fragment column pair
    const int r_tile = (threadIdx.x >> 5) * 16 + g;   // this lane's rows: r_tile, r_tile + 8
    const int qi[2] = {q_start + r_tile, q_start + r_tile + 8};

    const bf16* qb = static_cast<const bf16*>(p.q) + ((size_t)b * p.Hq + hq) * p.N * D
                     + (size_t)q_start * D;
    const bf16* kb = static_cast<const bf16*>(p.k) + ((size_t)b * p.H + h) * p.M * D;
    const bf16* vb = static_cast<const bf16*>(p.v) + ((size_t)b * p.H + h) * p.M * D;

    load_bf16_tile<D, LD, BF16_THREADS>(qs, qb, BQ, min(BQ, p.N - q_start));
    __syncthreads();
    uint32_t qf[KSTEPS][4];          // Q as A fragments, for the whole kv walk
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
        const bf16* base = qs + r_tile * LD + st * 16 + 2 * t;
        qf[st][0] = ld_pair(base);
        qf[st][1] = ld_pair(base + 8 * LD);
        qf[st][2] = ld_pair(base + 8);
        qf[st][3] = ld_pair(base + 8 * LD + 8);
    }
    bool q_special[2] = {false, false};
    if (p.num_special > 0) {
        q_special[0] = is_special(qi[0] + p.offset, p);
        q_special[1] = is_special(qi[1] + p.offset, p);
    }

    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};
    float acc[NB_O][4];              // acc[nb][2r + e]: row r_tile + 8r, column 8nb + 2t + e
#pragma unroll
    for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
    }

    const int k_end = kv_end(q_start, BQ, p);
    for (int k_start = 0; k_start < k_end; k_start += BK) {
        const int valid_k = min(BK, k_end - k_start);
        __syncthreads();   // previous tile's ks/vs fully consumed
        load_bf16_tile<D, LD, BF16_THREADS>(ks, kb + (size_t)k_start * D, BK, valid_k);
        load_bf16_tile<D, LD, BF16_THREADS>(vs, vb + (size_t)k_start * D, BK, valid_k);
        __syncthreads();

        // s[nb][2r + e]: row r_tile + 8r, key k_start + 8nb + 2t + e
        float s[NB_S][4];
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
            for (int st = 0; st < KSTEPS; ++st) {
                const bf16* krow = ks + (nb * 8 + g) * LD + st * 16 + 2 * t;
                const uint32_t kf[2] = {ld_pair(krow), ld_pair(krow + 8)};
                mma_16816(s[nb], qf[st], kf);
            }
        }

        float tile_max[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                s[nb][e] = masked_score(s[nb][e], qi[r], q_special[r],
                                        k_start + nb * 8 + 2 * t + (e & 1), p);
                tile_max[r] = fmaxf(tile_max[r], s[nb][e]);
            }
        }
        float alpha[2], m_new[2], p_sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            // the four lanes of a row group hold its 64 scores
            tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
            tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
            m_new[r] = fmaxf(m_run[r], tile_max[r]);
            alpha[r] = __expf(m_run[r] - m_new[r]);
        }
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[nb][e] = __expf(s[nb][e] - m_new[e >> 1]);
                p_sum[e >> 1] += s[nb][e];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            p_sum[r] += __shfl_xor_sync(0xffffffffu, p_sum[r], 1);
            p_sum[r] += __shfl_xor_sync(0xffffffffu, p_sum[r], 2);
            l_run[r] = l_run[r] * alpha[r] + p_sum[r];
            m_run[r] = m_new[r];
        }
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            acc[nb][0] *= alpha[0];
            acc[nb][1] *= alpha[0];
            acc[nb][2] *= alpha[1];
            acc[nb][3] *= alpha[1];
        }

        // O += P . V: the score accumulators of key blocks 2kk, 2kk + 1 are
        // exactly the A fragment of keys 16kk .. 16kk + 15, rounded to bf16
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t pf[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                    pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int nb = 0; nb < NB_O; ++nb) {
                uint32_t vf[2];
                ldmatrix_x2_trans(vf, vs + (kk * 16 + (lane & 15)) * LD + nb * 8);
                mma_16816(acc[nb], pf, vf);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (qi[r] >= p.N) continue;
        const float l = fmaxf(l_run[r], 1e-30f);
        bf16* orow = static_cast<bf16*>(p.o) + (((size_t)b * p.Hq + hq) * p.N + qi[r]) * D;
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * t) =
                pack_bf16x2(acc[nb][2 * r] / l, acc[nb][2 * r + 1] / l);
        }
        if (p.lse != nullptr && t == 0) {
            p.lse[((size_t)b * p.Hq + hq) * p.N + qi[r]] = m_run[r] + logf(l);
        }
    }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
    constexpr int LD = D + 8;
    const size_t smem = sizeof(bf16) * (size_t)(BQ + 2 * BK) * LD;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BQ - 1) / BQ, p.Hq, B);
    flash_fwd_bf16<D><<<grid, BF16_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// ------------------------------------- bf16, head dims 64 and 128: Hopper

constexpr int SM90_THREADS = 160;   // one consumer warpgroup (64 query rows) + one producer warp
// k/v ring depth: 2 stages were 6-10% slower at the training shape on an
// H100, 4 no faster (scripts/time_torch_flash.py, PERF.md)
constexpr int STAGES = 3;

// Blocks per SM the compiler must fit: 3 at D = 64 caps a thread at 128
// registers without spills; 4 (96 registers) spill and were slower. At
// D = 128 a block takes 113 KB of shared memory: 1 per SM.
constexpr int sm90_min_blocks(int D) { return D == 64 ? 3 : 1; }

__device__ __forceinline__ float rcp_approx(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// a masked score in log2 units: NEG_INF * log2(e), so that the LSE of a row
// that sees no key is NEG_INF + log(l), as in the other kernels
constexpr float MASKED2 = NEG_INF * LOG2E;
constexpr float LN2 = 0.6931471805599453f;

struct Sm90Params : MaskParams {
    CUtensorMap q;                 // (B * Hq, N, D), boxes of 64 rows
    CUtensorMap k, v;              // (B * H, min(kv_len, M), D), boxes of 64 rows
    bf16* o;
    float* lse;                    // null: no LSE
    float score_k;                 // log2(e) * softclamp, or log2(e) * scale without one
    int Hq, H;
};

// byte offsets in the block's shared memory (from a 1024-byte aligned base)
template <int D>
struct Sm90Layout {
    static constexpr int TILE = BQ * D * 2;     // a 64-row tile (BQ == BK)
    static constexpr int SLAB = 64 * 128;       // one 64-column slab of it
    static constexpr int Q = 0;
    static constexpr int K = TILE, V = K + STAGES * TILE;
    static constexpr int BARS = V + STAGES * TILE;    // full, empty (STAGES each), resident
    static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;   // + alignment slack
};

// S = Q K^T of one 64 x 64 tile (s[4j + 2r + e]: row g + 8r of the warp, key
// 8j + 2t + e), both K-major, as one commit group
template <int D>
__device__ __forceinline__ void scores_async(float (&s)[32], const uint8_t* qt, const uint8_t* kt) {
    using namespace sm90;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * Sm90Layout<D>::SLAB + (kk % 4) * 32;
        wgmma_ss_n64(s, sw128_desc(qt + off, 16, 1024), sw128_desc(kt + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
}

// O += P V of one tile as one commit group: P from registers (pf[kk]: keys
// 16 kk .. 16 kk + 15), the v tile MN-major (its rows are the reduced keys)
template <int D>
__device__ __forceinline__ void pv_async(float (&o)[D / 64][32], const uint32_t (&pf)[4][4],
                                         const uint8_t* vt) {
    using namespace sm90;
    constexpr int SLAB = Sm90Layout<D>::SLAB;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int s = 0; s < D / 64; ++s) {
            wgmma_rs_n64_mn(o[s], pf[kk], sw128_desc(vt + s * SLAB + kk * 16 * 128, SLAB, 1024));
        }
    }
    wgmma_commit();
}

// The mask of one query row on a tile of 64 keys (the row's 16 columns k0 +
// 8 j + e in a thread): the row sees keys below `limit` (kv_len, M, the
// causal diagonal; 0 for a row past N) among the columns whose bit 2 j + e
// is set in `cols` (the special-token rule).
struct RowMask {
    int limit;
    uint32_t cols;
};

// The masks of the thread's two rows qi[r] (q_sp: their special flags) on
// the tile of 64 keys at k_start: one pos_mod for the special flags of the
// thread's 16 columns, then per row the columns the special-token rule
// leaves, as `visible_given` decides.
__device__ __forceinline__ void row_masks(RowMask (&rm)[2], const int (&qi)[2],
                                          const bool (&q_sp)[2], int k0, const MaskParams& p) {
    const uint32_t k_sp = p.num_special > 0 ? special_bits<8>(k0, p) : 0u;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        int limit = min(p.kv_len, p.M);
        if (p.causal) limit = min(limit, qi[r] + p.offset + 1);
        rm[r].limit = qi[r] < p.N ? limit : 0;
        rm[r].cols = 0xffffu;
        if (p.num_special > 0) {
            if (p.special_only_itself && q_sp[r]) rm[r].cols = k_sp;     // special keys only
            if (!p.special_only_itself && !q_sp[r]) rm[r].cols = ~k_sp;  // no special key
        }
    }
}

// One tile's online-softmax step, in place on its raw scores s (s[4j + 2r +
// e]: row r of the thread, key k0 + 8j + e): each score in log2 units (the
// softclamp as `clamp_score` takes it, c (1 - 2 / (e + 1)) with e = 2^(tanh_k
// dot), without its clamp of the exponent to [-43, 43]: beyond it tanh
// rounds to +-1 in float32 either way, and e = 0 or +inf gives -1 or 1 here;
// MASKED2 where masked), the row maxima
// m2 raised, alpha = 2^(old max - new max), this thread's share of the row
// sums l rescaled and increased, and s replaced by p = 2^(score - max).
// Without MASKED every pair is visible.
template <bool MASKED, bool CLAMP>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m2)[2], float (&l)[2],
                                             float (&alpha)[2], const RowMask (&rm)[2], int k0,
                                             const Sm90Params& p) {
    float mx[2] = {m2[0], m2[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int idx = 4 * j + 2 * r + e;
                float x;
                if (CLAMP) {
                    const float ex = exp2_approx(s[idx] * p.tanh_k);
                    x = fmaf(rcp_approx(ex + 1.f), -2.f * p.score_k, p.score_k);
                } else {
                    x = s[idx] * p.score_k;
                }
                const int c = 2 * j + e;
                if (MASKED && !(k0 + 8 * j + e < rm[r].limit && ((rm[r].cols >> c) & 1u))) {
                    x = MASKED2;
                }
                s[idx] = x;
                mx[r] = fmaxf(mx[r], x);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        // the four lanes of a row group hold its 64 scores
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m2[r] - mx[r]);
        m2[r] = mx[r];
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int idx = 4 * j + 2 * r + e;
                s[idx] = exp2_approx(s[idx] - m2[r]);
                l[r] += s[idx];
            }
        }
    }
}

template <bool CLAMP>
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m2)[2], float (&l)[2],
                                             float (&alpha)[2], const int (&qi)[2],
                                             const bool (&q_sp)[2], int q_start, int k_start,
                                             int t, const Sm90Params& p) {
    if (tile_all_visible(q_start, 64, k_start, BK, p)) {
        const RowMask all[2] = {};
        softmax_tile<false, CLAMP>(s, m2, l, alpha, all, 0, p);
    } else {
        const int k0 = k_start + 2 * t;
        RowMask rm[2];
        row_masks(rm, qi, q_sp, k0, p);
        softmax_tile<true, CLAMP>(s, m2, l, alpha, rm, k0, p);
    }
}

// p rounded to bf16 as the A fragments of O += P V (pf[kk]: keys 16 kk ..
// 16 kk + 15)
__device__ __forceinline__ void p_fragments(uint32_t (&pf)[4][4], const float (&s)[32]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            pf[j >> 1][(j & 1) * 2 + r] = pack_bf16x2(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
        }
    }
}

template <int D, bool CLAMP>
__global__ void __launch_bounds__(SM90_THREADS, sm90_min_blocks(D))
    flash_fwd_sm90(const __grid_constant__ Sm90Params p) {
    using namespace sm90;
    using L = Sm90Layout<D>;
    constexpr int NS = D / 64;       // slabs per row

    extern __shared__ __align__(1024) uint8_t sm90_smem[];
    uint8_t* sm = align_1024(sm90_smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
    uint64_t* empty = full + STAGES;
    uint64_t* resident = empty + STAGES;

    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;   // the longest causal walk first
    const int hq = blockIdx.y;
    const int b = blockIdx.z;
    const int bhq = b * p.Hq + hq;
    const int bh = b * p.H + hq / (p.Hq / p.H);
    const int n_tiles = (kv_end(q_start, BQ, p) + BK - 1) / BK;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4);   // one arrival per consumer warp
        }
        mbar_init(resident, 1);
        fence_barrier_init();
    }
    __syncthreads();

    if (warp == 4) {   // producer: the q tile once, then the kv tiles through the ring
        if (lane == 0) {
            mbar_expect_tx(resident, L::TILE);
            for (int s = 0; s < NS; ++s) {
                tma_load_3d(sm + L::Q + s * L::SLAB, &p.q, resident, 64 * s, q_start, bhq);
            }
            for (int i = 0; i < n_tiles; ++i) {
                const int st = i % STAGES;
                mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[st], 2 * L::TILE);
                for (int s = 0; s < NS; ++s) {
                    tma_load_3d(sm + L::K + st * L::TILE + s * L::SLAB, &p.k, &full[st], 64 * s,
                                i * BK, bh);
                    tma_load_3d(sm + L::V + st * L::TILE + s * L::SLAB, &p.v, &full[st], 64 * s,
                                i * BK, bh);
                }
            }
        }
        return;
    }

    // consumer warpgroup: warp w owns query rows 16 w .. 16 w + 15
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint8_t* qt = sm + L::Q;

    int qi[2];
    bool q_sp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        qi[r] = q_start + warp * 16 + g + 8 * r;
        q_sp[r] = p.num_special > 0 && is_special(qi[r] + p.offset, p);
    }
    float m2[2] = {MASKED2, MASKED2};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float o[NS][32];                 // o[s][4j + 2r + e]: row qi[r], column 64 s + 8j + 2t + e
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[s][i] = 0.f;
    }
    const auto release = [&](int i) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[i % STAGES]);
    };
    mbar_wait(resident, 0);   // also where no tile is computed: no copy outlives the block

    if (n_tiles > 0) {
        float s[32];
        uint32_t pf[4][4];
        mbar_wait(&full[0], 0);
        wgmma_fence();
        scores_async<D>(s, qt, sm + L::K);
        wgmma_wait<0>();
        fence_regs(s);
        softmax_step<CLAMP>(s, m2, l, alpha, qi, q_sp, q_start, 0, t, p);
        p_fragments(pf, s);

        for (int i = 1; i < n_tiles; ++i) {
            const int st = i % STAGES;
            const uint8_t* v_prev = sm + L::V + ((i - 1) % STAGES) * L::TILE;
            mbar_wait(&full[st], (i / STAGES) & 1);
            // S of tile i, then P V of tile i - 1: this tile's exponentials
            // run while the tensor cores work on the product. P's fragments
            // are rewritten only after that product completed.
            fence_regs(s);
#pragma unroll
            for (int sl = 0; sl < NS; ++sl) fence_regs(o[sl]);
            wgmma_fence();
            scores_async<D>(s, qt, sm + L::K + st * L::TILE);
            pv_async<D>(o, pf, v_prev);
            wgmma_wait<1>();
            fence_regs(s);
            softmax_step<CLAMP>(s, m2, l, alpha, qi, q_sp, q_start, i * BK, t, p);
            wgmma_wait<0>();
#pragma unroll
            for (int sl = 0; sl < NS; ++sl) {
                fence_regs(o[sl]);
#pragma unroll
                for (int x = 0; x < 32; ++x) o[sl][x] *= alpha[(x >> 1) & 1];
            }
            release(i - 1);
            p_fragments(pf, s);
        }
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) fence_regs(o[sl]);
        wgmma_fence();
        pv_async<D>(o, pf, sm + L::V + ((n_tiles - 1) % STAGES) * L::TILE);
        wgmma_wait<0>();
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) fence_regs(o[sl]);
        release(n_tiles - 1);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        // the row's sum over its four lanes' shares
        float lr = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
        lr = fmaxf(lr + __shfl_xor_sync(0xffffffffu, lr, 2), 1e-30f);
        if (qi[r] >= p.N) continue;
        bf16* orow = p.o + ((size_t)bhq * p.N + qi[r]) * D;
#pragma unroll
        for (int sl = 0; sl < NS; ++sl) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                *reinterpret_cast<uint32_t*>(orow + 64 * sl + 8 * j + 2 * t) = pack_bf16x2(
                    o[sl][4 * j + 2 * r] / lr, o[sl][4 * j + 2 * r + 1] / lr);
            }
        }
        if (p.lse != nullptr && t == 0) {
            p.lse[(size_t)bhq * p.N + qi[r]] = m2[r] * LN2 + logf(lr);
        }
    }
}

template <int D, bool CLAMP>
cudaError_t launch_sm90_as(const Sm90Params& p, int B, cudaStream_t stream) {
    constexpr int smem = Sm90Layout<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90<D, CLAMP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BQ - 1) / BQ, p.Hq, B);
    flash_fwd_sm90<D, CLAMP><<<grid, SM90_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_sm90(const Params& in, int B, cudaStream_t stream) {
    Sm90Params p;
    static_cast<MaskParams&>(p) = in;
    const int kv_rows = max(1, min(in.kv_len, in.M));
    const bool maps = sm90::make_rows_map(&p.q, in.q, D, in.N, in.N, B * in.Hq, BQ) &&
                      sm90::make_rows_map(&p.k, in.k, D, in.M, kv_rows, B * in.H, BK) &&
                      sm90::make_rows_map(&p.v, in.v, D, in.M, kv_rows, B * in.H, BK);
    if (!maps) return cudaErrorInvalidValue;
    p.o = static_cast<bf16*>(in.o);
    p.lse = in.lse;
    p.score_k = LOG2E * (in.softclamp > 0.f ? in.softclamp : in.scale);
    p.Hq = in.Hq;
    p.H = in.H;
    return in.softclamp > 0.f ? launch_sm90_as<D, true>(p, B, stream)
                              : launch_sm90_as<D, false>(p, B, stream);
}

// variant: 0 = f32 (float32), 1 = mma (bf16), 2 = sm90 (bf16, D 64 or 128)
template <int D>
cudaError_t launch(const Params& p, int B, int dtype, int variant, cudaStream_t stream) {
    if (variant == 0 && dtype == 0) return launch_f32<D>(p, B, stream);
    if (variant == 1 && dtype == 1) return launch_bf16<D>(p, B, stream);
    if constexpr (D >= 64) {
        if (variant == 2 && dtype == 1) return launch_sm90<D>(p, B, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16;
// variant: the kernel, 0 = f32, 1 = mma, 2 = sm90 (see above; one that does
// not take dtype and D is refused). softclamp <= 0 means no softclamp. lse
// may be null. Returns the CUDA error code of the launch (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int Hq, int H, int N, int M, int D, int dtype, int offset,
                              int kv_len, float scale, float softclamp, int causal,
                              int num_special, int special_seq_len, int special_only_itself,
                              int variant, void* stream) {
    if (B <= 0 || Hq <= 0 || H <= 0 || N <= 0 || M <= 0 || Hq % H != 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (B > 65535 || Hq > 65535) return (int)cudaErrorInvalidValue;   // grid y, z limits
    if (num_special > 0 && special_seq_len <= 0) return (int)cudaErrorInvalidValue;
    Params p;
    static_cast<MaskParams&>(p) = make_mask_params(N, M, offset, kv_len, scale, softclamp, causal,
                                                   num_special, special_seq_len,
                                                   special_only_itself);
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.lse = lse;
    p.Hq = Hq;
    p.H = H;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return (int)launch<16>(p, B, dtype, variant, s);
        case 32: return (int)launch<32>(p, B, dtype, variant, s);
        case 64: return (int)launch<64>(p, B, dtype, variant, s);
        case 128: return (int)launch<128>(p, B, dtype, variant, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
