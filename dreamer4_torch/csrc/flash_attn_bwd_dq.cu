// Flash-attention backward, query gradient, for Hopper (sm_90a): K2 of the port.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` in
// dreamer4_tpu/ops/flash_attention.py, together with the delta =
// rowsum(dO * O) its host `flash_attend_bwd` computes before it. Per query
// row it computes delta in float32 and writes it to a (B, Hq, N) buffer
// for K3; then, from the forward's saved log-sum-exp, per (q, k) pair
//
//   s   = softclamp(scale * q . k)                     float32, as K1
//   p   = visible ? exp(s - lse) : 0                   zeroed by the mask predicate
//   dp  = dO . v
//   ds  = p * (dp - delta) * (1 - tanh^2)              the softclamp's derivative
//   dq  = scale * sum_k ds . k                         ds rounded to k's type
//
// with the mask family of K1 (flash_attn_common.cuh): kv_len, causal under
// an offset that may be negative, periodic special tokens in either
// direction; query head h reads kv head h / groups. p is zeroed by the
// predicate, not by underflow, so a fully masked row or a padded LSE gives
// zero, never NaN.
//
// Layout: q, o, dO, dq (B, Hq, N, D); k, v (B, H, M, D); lse, delta
// (B, Hq, N) float32; all contiguous. D is 16, 32, 64 or 128; float32 or
// bf16. One block per (q tile of 64 rows, q head, batch) walks the kv tiles
// of 64 rows the tile can see (tiles past kv_len or above the causal
// diagonal are never read) and keeps dq in registers; nothing is carried
// between blocks, so there are no atomics and dq is the same from run to run.
//
// bf16, head dim 64 and 128 (the models' path): `bwd_dq_sm90`.
//   - One producer warp issues TMA loads (cp.async.bulk.tensor): q, dO and o
//     once, then the k and v tiles through a ring of STAGES stages with full
//     and empty mbarriers. The k/v tensor maps end at min(kv_len, M), so TMA
//     writes zeros for the rows past it: a NaN in an unused cache row reaches
//     no gradient.
//   - One consumer warpgroup (4 warps, 64 query rows) computes delta from
//     the staged o and dO, then per kv tile S = Q K^T and dP = dO V^T with
//     `wgmma` from shared memory (both K-major) in two commit groups, so that
//     p (the exponentials) is computed while dP is still on the tensor cores,
//     ds in the S accumulators, and dQ += dS K with dS as the register A
//     operand (rounded to bf16) and the k tile as the MN-major B operand: no
//     transposed copy.
//   - Registers per consumer thread: S 32 + dP 32 + dQ 32 (D = 64) or 64
//     (D = 128) float32, dS 16 packed, plus indices and row statistics: 128
//     at D = 64, where the compiler is held to 3 blocks per SM, about 175 at
//     D = 128 (1 block, by shared memory), so no setmaxnreg.
//   - Tiles wholly inside the visible region skip the mask predicate; the
//     others get the special flags of their columns once per tile. log2(e)
//     is folded into the LSE. Blocks run the longest causal walk of each
//     head first (the q tile index counts down).
// bf16, head dims 16 and 32 (tests only): `bwd_dq_bf16`, four warps on
//   `mma.sync.m16n8k16` from padded shared tiles, no copy pipeline.
// float32: `bwd_dq_f32`, 256 threads on the float32 cores, four per query
//   row; ds goes through a shared 64 x 64 tile to the dq product.
//
// Bounds at the training shape (B=27, H=8, N=M=1024, D=64, causal, bf16;
// 113.4M visible pairs): bytes 171.6 MB (q, o, dO, k, v, lse read; dq,
// delta written) 0.051 ms at 3.35 TB/s; tensor cores 6 D operations per
// pair (s, dp, dq), 43.5 GFLOP, 0.044 ms at 989 TFLOP/s; exponential unit
// 2 transcendentals per pair (tanh, exp), 0.054 ms at 16 per clock per SM
// x 132 SMs x 1.98 GHz. The exponential unit binds. As the kernel computes
// it, the softclamp costs an exponential and a reciprocal, and the diagonal
// tiles evaluate their masked halves: 3 x 120.3M special-function
// operations, 0.086 ms, the floor of this design.

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
    const void* dout;
    const void* o;
    const float* lse;
    float* delta;                  // written: rowsum(dO * O)
    void* dq;
    int Hq, H;
};

// delta = rowsum(dO * O) in float32 of the block's BQ query rows (valid_q of
// them real), one thread per row, into delta_s, and into the global delta.
template <typename T, int D>
__device__ __forceinline__ void block_delta(float* delta_s, const T* ob, const T* dob,
                                            float* delta_out, int valid_q) {
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
        float acc = 0.f;
        if (r < valid_q) {
            for (int d = 0; d < D; ++d) {
                acc = fmaf(to_float(dob[(size_t)r * D + d]), to_float(ob[(size_t)r * D + d]), acc);
            }
            delta_out[r] = acc;
        }
        delta_s[r] = acc;
    }
}

// ------------------------------------------------------------------ float32

constexpr int F32_THREADS = 256;   // 4 threads per query row
constexpr int F32_COLS = BK / 4;   // pairs per thread per tile

template <int D>
__global__ void __launch_bounds__(F32_THREADS) bwd_dq_f32(const Params p) {
    constexpr int LD = D + 4;        // padded row stride of q/dO/k/v tiles
    constexpr int LDS = BK + 4;      // padded row stride of the ds tile
    constexpr int DC = D / 4;        // output columns per thread

    extern __shared__ float smem[];
    float* qs = smem;                    // BQ x LD
    float* dos = qs + BQ * LD;           // BQ x LD
    float* ks = dos + BQ * LD;           // BK x LD
    float* vs = ks + BK * LD;            // BK x LD
    float* dss = vs + BK * LD;           // BQ x LDS
    float* delta_s = dss + BQ * LDS;     // BQ

    const int q_start = blockIdx.x * BQ;
    const int hq = blockIdx.y;
    const int b = blockIdx.z;
    const int h = hq / (p.Hq / p.H);
    const int row = threadIdx.x >> 2;
    const int quad = threadIdx.x & 3;
    const int qi = q_start + row;

    const size_t q_rows = ((size_t)b * p.Hq + hq) * p.N;
    const float* qb = static_cast<const float*>(p.q) + (q_rows + q_start) * D;
    const float* dob = static_cast<const float*>(p.dout) + (q_rows + q_start) * D;
    const float* kb = static_cast<const float*>(p.k) + ((size_t)b * p.H + h) * p.M * D;
    const float* vb = static_cast<const float*>(p.v) + ((size_t)b * p.H + h) * p.M * D;

    const int valid_q = min(BQ, p.N - q_start);
    load_f32_tile<D, LD, F32_THREADS>(qs, qb, BQ, valid_q);
    load_f32_tile<D, LD, F32_THREADS>(dos, dob, BQ, valid_q);
    block_delta<float, D>(delta_s, static_cast<const float*>(p.o) + (q_rows + q_start) * D, dob,
                          p.delta + q_rows + q_start, valid_q);
    __syncthreads();
    const float lse = qi < p.N ? p.lse[q_rows + qi] : 0.f;
    const float delta = delta_s[row];
    const bool q_special = p.num_special > 0 && is_special(qi + p.offset, p);

    float acc[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[j] = 0.f;

    const int k_end = kv_end(q_start, BQ, p);
    for (int k_start = 0; k_start < k_end; k_start += BK) {
        const int valid_k = min(BK, k_end - k_start);
        __syncthreads();   // previous tile's ks/vs/dss fully consumed
        load_f32_tile<D, LD, F32_THREADS>(ks, kb + (size_t)k_start * D, BK, valid_k);
        load_f32_tile<D, LD, F32_THREADS>(vs, vb + (size_t)k_start * D, BK, valid_k);
        __syncthreads();

        // s and dp for keys quad + 4 * j
        float s[F32_COLS], dp[F32_COLS];
#pragma unroll
        for (int j = 0; j < F32_COLS; ++j) s[j] = dp[j] = 0.f;
        const float* qrow = qs + row * LD;
        const float* dorow = dos + row * LD;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
            const float4 gv = *reinterpret_cast<const float4*>(dorow + d);
#pragma unroll
            for (int j = 0; j < F32_COLS; ++j) {
                const float4 kv4 = *reinterpret_cast<const float4*>(ks + (quad + 4 * j) * LD + d);
                const float4 vv4 = *reinterpret_cast<const float4*>(vs + (quad + 4 * j) * LD + d);
                s[j] = fmaf(qv.x, kv4.x, fmaf(qv.y, kv4.y, fmaf(qv.z, kv4.z, fmaf(qv.w, kv4.w, s[j]))));
                dp[j] = fmaf(gv.x, vv4.x, fmaf(gv.y, vv4.y, fmaf(gv.z, vv4.z, fmaf(gv.w, vv4.w, dp[j]))));
            }
        }
        float* dsrow = dss + row * LDS;
#pragma unroll
        for (int j = 0; j < F32_COLS; ++j) {
            const int kj = k_start + quad + 4 * j;
            float dscore;
            const float x = clamp_score(s[j], p, dscore);
            const bool ok = visible(qi, q_special, kj, p);
            const float pr = ok ? __expf(x - lse) : 0.f;
            dsrow[quad + 4 * j] = ok ? pr * (dp[j] - delta) * dscore : 0.f;
        }
        __syncthreads();   // the row's ds is written by 4 threads

        // acc[c] covers output columns 4 * quad + 16 * (c / 4) + c % 4
        for (int c = 0; c < BK; ++c) {
            const float dsc = dsrow[c];
            const float* krow = ks + c * LD + 4 * quad;
#pragma unroll
            for (int j = 0; j < DC / 4; ++j) {
                const float4 k4 = *reinterpret_cast<const float4*>(krow + 16 * j);
                acc[4 * j + 0] = fmaf(dsc, k4.x, acc[4 * j + 0]);
                acc[4 * j + 1] = fmaf(dsc, k4.y, acc[4 * j + 1]);
                acc[4 * j + 2] = fmaf(dsc, k4.z, acc[4 * j + 2]);
                acc[4 * j + 3] = fmaf(dsc, k4.w, acc[4 * j + 3]);
            }
        }
    }

    if (qi < p.N) {
        float* dqrow = static_cast<float*>(p.dq) + (q_rows + qi) * D;
#pragma unroll
        for (int j = 0; j < DC / 4; ++j) {
            *reinterpret_cast<float4*>(dqrow + 4 * quad + 16 * j) =
                make_float4(acc[4 * j] * p.scale, acc[4 * j + 1] * p.scale,
                            acc[4 * j + 2] * p.scale, acc[4 * j + 3] * p.scale);
        }
    }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
    constexpr int LD = D + 4;
    constexpr int LDS = BK + 4;
    const size_t smem = sizeof(float) * (2 * (size_t)BQ * LD + 2 * (size_t)BK * LD
                                         + (size_t)BQ * LDS + BQ);
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BQ - 1) / BQ, p.Hq, B);
    bwd_dq_f32<D><<<grid, F32_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// ----------------------------------------------- bf16, head dims 16 and 32

constexpr int BF16_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
__global__ void __launch_bounds__(BF16_THREADS) bwd_dq_bf16(const Params p) {
    constexpr int LD = D + 8;        // bf16 row stride of the tiles (16-byte pad)
    constexpr int KSTEPS = D / 16;   // mma k-steps over the head dim
    constexpr int NB_S = BK / 8;     // 8-key column blocks of a score tile
    constexpr int NB_O = D / 8;      // 8-column blocks of dq

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
    bf16* dos = qs + BQ * LD;                       // BQ x LD
    bf16* ks = dos + BQ * LD;                       // BK x LD
    bf16* vs = ks + BK * LD;                        // BK x LD
    float* delta_s = reinterpret_cast<float*>(vs + BK * LD);   // BQ

    const int q_start = blockIdx.x * BQ;
    const int hq = blockIdx.y;
    const int b = blockIdx.z;
    const int h = hq / (p.Hq / p.H);
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;                          // fragment row group
    const int t = lane & 3;                           // fragment column pair
    const int w_row = (threadIdx.x >> 5) * 16;        // the warp's first row
    const int qi[2] = {q_start + w_row + g, q_start + w_row + g + 8};

    const size_t q_rows = ((size_t)b * p.Hq + hq) * p.N;
    const bf16* qb = static_cast<const bf16*>(p.q) + (q_rows + q_start) * D;
    const bf16* dob = static_cast<const bf16*>(p.dout) + (q_rows + q_start) * D;
    const bf16* kb = static_cast<const bf16*>(p.k) + ((size_t)b * p.H + h) * p.M * D;
    const bf16* vb = static_cast<const bf16*>(p.v) + ((size_t)b * p.H + h) * p.M * D;

    const int valid_q = min(BQ, p.N - q_start);
    load_bf16_tile<D, LD, BF16_THREADS>(qs, qb, BQ, valid_q);
    load_bf16_tile<D, LD, BF16_THREADS>(dos, dob, BQ, valid_q);
    block_delta<bf16, D>(delta_s, static_cast<const bf16*>(p.o) + (q_rows + q_start) * D, dob,
                         p.delta + q_rows + q_start, valid_q);
    __syncthreads();
    float lse[2], delta[2];
    bool q_special[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        lse[r] = qi[r] < p.N ? p.lse[q_rows + qi[r]] : 0.f;
        delta[r] = delta_s[w_row + g + 8 * r];
        q_special[r] = p.num_special > 0 && is_special(qi[r] + p.offset, p);
    }

    float acc[NB_O][4];              // acc[nb][2r + e]: row g + 8r, column 8nb + 2t + e
#pragma unroll
    for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
    }

    const int k_end = kv_end(q_start, BQ, p);
    for (int k_start = 0; k_start < k_end; k_start += BK) {
        const int valid_k = min(BK, k_end - k_start);
        __syncthreads();   // previous tile's ks/vs fully consumed (and q/dO staged)
        load_bf16_tile<D, LD, BF16_THREADS>(ks, kb + (size_t)k_start * D, BK, valid_k);
        load_bf16_tile<D, LD, BF16_THREADS>(vs, vb + (size_t)k_start * D, BK, valid_k);
        __syncthreads();

        // s[nb][2r + e], dp[nb][2r + e]: row g + 8r, key k_start + 8nb + 2t + e
        float s[NB_S][4], dp[NB_S][4];
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
        }
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) {
            uint32_t qf[4], gf[4];
            load_a_frag<LD>(qf, qs, w_row, st * 16, g, t);
            load_a_frag<LD>(gf, dos, w_row, st * 16, g, t);
#pragma unroll
            for (int nb = 0; nb < NB_S; ++nb) {
                uint32_t kf[2], vf[2];
                load_b_frag<LD>(kf, ks, nb * 8, st * 16, g, t);
                load_b_frag<LD>(vf, vs, nb * 8, st * 16, g, t);
                mma_16816(s[nb], qf, kf);
                mma_16816(dp[nb], gf, vf);
            }
        }

        // ds into the score accumulators
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const int kj = k_start + nb * 8 + 2 * t + (e & 1);
                float dscore;
                const float x = clamp_score(s[nb][e], p, dscore);
                const bool ok = visible(qi[r], q_special[r], kj, p);
                const float pr = ok ? __expf(x - lse[r]) : 0.f;
                s[nb][e] = ok ? pr * (dp[nb][e] - delta[r]) * dscore : 0.f;
            }
        }

        // dq += ds . K, ds rounded to bf16 (the TPU kernel's ds.astype(k.dtype))
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t af[4];
            acc_to_a_frag(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int nb = 0; nb < NB_O; ++nb) {
                uint32_t kf[2];
                ldmatrix_x2_trans(kf, ks + (kk * 16 + (lane & 15)) * LD + nb * 8);
                mma_16816(acc[nb], af, kf);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (qi[r] >= p.N) continue;
        bf16* dqrow = static_cast<bf16*>(p.dq) + (q_rows + qi[r]) * D;
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            *reinterpret_cast<uint32_t*>(dqrow + nb * 8 + 2 * t) =
                pack_bf16x2(acc[nb][2 * r] * p.scale, acc[nb][2 * r + 1] * p.scale);
        }
    }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
    constexpr int LD = D + 8;
    const size_t smem = sizeof(bf16) * (size_t)(2 * BQ + 2 * BK) * LD + sizeof(float) * BQ;
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BQ - 1) / BQ, p.Hq, B);
    bwd_dq_bf16<D><<<grid, BF16_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// ------------------------------------- bf16, head dims 64 and 128: Hopper

constexpr int SM90_THREADS = 160;  // one consumer warpgroup + one producer warp
constexpr int STAGES = 2;          // k/v ring depth (3 was no faster)

// Blocks per SM the compiler must fit: 3 at D = 64 caps a thread at 128
// registers (no spills; 134 without the cap, 2 blocks, 1.2x the time at the
// training shape on an H100). D = 128 takes 116 KB of shared memory: 1 block.
constexpr int sm90_min_blocks(int D) { return D == 64 ? 3 : 1; }

struct Sm90Params : MaskParams {
    CUtensorMap q, dout, o;        // (B * Hq, N, D), boxes of 64 rows
    CUtensorMap k, v;              // (B * H, min(kv_len, M), D), boxes of 64 rows
    const float* lse;
    float* delta;
    bf16* dq;
    int Hq, H;
};

// byte offsets in the block's shared memory (from a 1024-byte aligned base)
template <int D>
struct Sm90Layout {
    static constexpr int TILE = BQ * D * 2;     // a 64-row tile (BQ == BK)
    static constexpr int SLAB = BQ * 128;       // one 64-column slab of it
    static constexpr int Q = 0, DO = TILE, O = 2 * TILE;
    static constexpr int K = 3 * TILE, V = K + STAGES * TILE;
    static constexpr int DELTA = V + STAGES * TILE;        // BQ floats
    static constexpr int BARS = DELTA + BQ * 4;            // full, empty (STAGES each), resident
    static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;   // + alignment slack
};

// p * (1 - tanh^2) of a 64 x 64 tile, in place of its scores s (s[4j + 2r +
// e]: row g + 8r, key k0 + 8j + e), zero where masked. Without MASKED every
// pair is visible.
template <bool MASKED, bool CLAMP>
__device__ __forceinline__ void p_times_dscore(float (&s)[32], const float (&lse2)[2],
                                               const int (&qi)[2], const bool (&q_sp)[2], int k0,
                                               uint32_t k_sp, const MaskParams& p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int idx = 4 * j + 2 * r + e;
                float dscore;
                const float pr = backward_p<CLAMP>(s[idx], lse2[r], p, dscore);
                const bool ok = !MASKED || visible_given(qi[r], q_sp[r], k0 + 8 * j + e,
                                                         (k_sp >> (2 * j + e)) & 1u, p);
                s[idx] = ok ? pr * dscore : 0.f;
            }
        }
    }
}

// dS = p dscore (dP - delta), rounded to bf16, as the A fragments of
// dQ += dS . K: af[kk] holds keys 16 kk .. 16 kk + 15.
__device__ __forceinline__ void ds_fragments(uint32_t (&af)[4][4], const float (&pd)[32],
                                             const float (&dp)[32], const float (&delta)[2]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int idx = 4 * j + 2 * r;
            af[j >> 1][(j & 1) * 2 + r] = pack_bf16x2(pd[idx] * (dp[idx] - delta[r]),
                                                      pd[idx + 1] * (dp[idx + 1] - delta[r]));
        }
    }
}

template <int D, bool CLAMP>
__global__ void __launch_bounds__(SM90_THREADS, sm90_min_blocks(D))
    bwd_dq_sm90(const __grid_constant__ Sm90Params p) {
    using namespace sm90;
    using L = Sm90Layout<D>;
    constexpr int NS = D / 64;       // slabs per row
    constexpr uint32_t SBO = 1024;   // bytes per 8-row group of a slab

    extern __shared__ __align__(1024) uint8_t sm90_smem[];
    uint8_t* sm = align_1024(sm90_smem);
    float* delta_s = reinterpret_cast<float*>(sm + L::DELTA);
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

    if (warp == 4) {   // producer: q, dO, o once, then the kv tiles through the ring
        if (lane == 0) {
            mbar_expect_tx(resident, 3 * L::TILE);
            for (int s = 0; s < NS; ++s) {
                tma_load_3d(sm + L::Q + s * L::SLAB, &p.q, resident, 64 * s, q_start, bhq);
                tma_load_3d(sm + L::DO + s * L::SLAB, &p.dout, resident, 64 * s, q_start, bhq);
                tma_load_3d(sm + L::O + s * L::SLAB, &p.o, resident, 64 * s, q_start, bhq);
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
    const int tid = threadIdx.x;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int w_row = warp * 16;
    mbar_wait(resident, 0);

    // delta = rowsum(dO * O): two threads per row, each over four of the
    // eight 16-byte chunks of every slab row (swizzled positions)
    {
        const int r = tid >> 1;
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int chunk = (tid & 1) * 4 + c;
                const int off = s * L::SLAB + r * 128 + ((chunk ^ (r & 7)) << 4);
                acc = dot8_bf16(*reinterpret_cast<const uint4*>(sm + L::O + off),
                                *reinterpret_cast<const uint4*>(sm + L::DO + off), acc);
            }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if ((tid & 1) == 0) {
            delta_s[r] = acc;
            if (q_start + r < p.N) p.delta[(size_t)bhq * p.N + q_start + r] = acc;
        }
    }
    named_barrier_sync(1, 128);

    int qi[2];
    float lse2[2], delta[2];
    bool q_sp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        qi[r] = q_start + w_row + g + 8 * r;
        lse2[r] = qi[r] < p.N ? p.lse[(size_t)bhq * p.N + qi[r]] * LOG2E : 0.f;
        delta[r] = delta_s[w_row + g + 8 * r];
        q_sp[r] = p.num_special > 0 && is_special(qi[r] + p.offset, p);
    }

    float dq[NS][32];                // dq[s][4j + 2r + e]: row g + 8r, column 64 s + 8j + 2t + e
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[s][i] = 0.f;
    }

    for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        const int k_start = i * BK;
        const uint8_t* kt = sm + L::K + st * L::TILE;
        const uint8_t* vt = sm + L::V + st * L::TILE;
        mbar_wait(&full[st], (i / STAGES) & 1);

        // S = Q K^T, then dP = dO V^T in a second group: p is computed while
        // the tensor cores still work on dP
        float s_acc[32], dp_acc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int off = (kk / 4) * L::SLAB + (kk % 4) * 32;
            wgmma_ss_n64(s_acc, sw128_desc(sm + L::Q + off, 16, SBO), sw128_desc(kt + off, 16, SBO),
                         kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int off = (kk / 4) * L::SLAB + (kk % 4) * 32;
            wgmma_ss_n64(dp_acc, sw128_desc(sm + L::DO + off, 16, SBO),
                         sw128_desc(vt + off, 16, SBO), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s_acc);

        if (tile_all_visible(q_start, BQ, k_start, BK, p)) {
            p_times_dscore<false, CLAMP>(s_acc, lse2, qi, q_sp, 0, 0u, p);
        } else {
            const int k0 = k_start + 2 * t;
            // special flags of the thread's 16 key columns
            const uint32_t k_sp = p.num_special > 0 ? special_bits<8>(k0, p) : 0u;
            p_times_dscore<true, CLAMP>(s_acc, lse2, qi, q_sp, k0, k_sp, p);
        }
        wgmma_wait<0>();
        fence_regs(dp_acc);
        uint32_t af[4][4];
        ds_fragments(af, s_acc, dp_acc, delta);

        // dQ += dS K: dS from registers, the k tile MN-major (its rows are the reduced keys)
#pragma unroll
        for (int s = 0; s < NS; ++s) fence_regs(dq[s]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                wgmma_rs_n64_mn(dq[s], af[kk],
                                sw128_desc(kt + s * L::SLAB + kk * 16 * 128, L::SLAB, SBO));
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int s = 0; s < NS; ++s) fence_regs(dq[s]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (qi[r] >= p.N) continue;
        bf16* dqrow = p.dq + ((size_t)bhq * p.N + qi[r]) * D;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                *reinterpret_cast<uint32_t*>(dqrow + 64 * s + 8 * j + 2 * t) = pack_bf16x2(
                    dq[s][4 * j + 2 * r] * p.scale, dq[s][4 * j + 2 * r + 1] * p.scale);
            }
        }
    }
}

template <int D, bool CLAMP>
cudaError_t launch_sm90_as(const Sm90Params& p, int B, cudaStream_t stream) {
    constexpr int smem = Sm90Layout<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_sm90<D, CLAMP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BQ - 1) / BQ, p.Hq, B);
    bwd_dq_sm90<D, CLAMP><<<grid, SM90_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_sm90(const Params& in, int B, cudaStream_t stream) {
    Sm90Params p;
    static_cast<MaskParams&>(p) = in;
    const int kv_rows = max(1, min(in.kv_len, in.M));
    const bool maps =
        sm90::make_rows_map(&p.q, in.q, D, in.N, in.N, B * in.Hq, BQ) &&
        sm90::make_rows_map(&p.dout, in.dout, D, in.N, in.N, B * in.Hq, BQ) &&
        sm90::make_rows_map(&p.o, in.o, D, in.N, in.N, B * in.Hq, BQ) &&
        sm90::make_rows_map(&p.k, in.k, D, in.M, kv_rows, B * in.H, BK) &&
        sm90::make_rows_map(&p.v, in.v, D, in.M, kv_rows, B * in.H, BK);
    if (!maps) return cudaErrorInvalidValue;
    p.lse = in.lse;
    p.delta = in.delta;
    p.dq = static_cast<bf16*>(in.dq);
    p.Hq = in.Hq;
    p.H = in.H;
    return in.softclamp > 0.f ? launch_sm90_as<D, true>(p, B, stream)
                              : launch_sm90_as<D, false>(p, B, stream);
}

template <int D>
cudaError_t launch(const Params& p, int B, int dtype, cudaStream_t stream) {
    if (dtype == 0) return launch_f32<D>(p, B, stream);
    if (dtype == 1) {
        if constexpr (D >= 64) {
            return launch_sm90<D>(p, B, stream);
        } else {
            return launch_bf16<D>(p, B, stream);
        }
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16.
// softclamp <= 0 means no softclamp. Writes dq and delta (float32, B x Hq x
// N). Returns the CUDA error code of the launch (0 on success); the launch
// is asynchronous on `stream`.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* o, const float* lse, float* delta, void* dq,
                                 int B, int Hq, int H, int N, int M, int D, int dtype, int offset,
                                 int kv_len, float scale, float softclamp, int causal,
                                 int num_special, int special_seq_len, int special_only_itself,
                                 void* stream) {
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
    p.dout = dout;
    p.o = o;
    p.lse = lse;
    p.delta = delta;
    p.dq = dq;
    p.Hq = Hq;
    p.H = H;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return (int)launch<16>(p, B, dtype, s);
        case 32: return (int)launch<32>(p, B, dtype, s);
        case 64: return (int)launch<64>(p, B, dtype, s);
        case 128: return (int)launch<128>(p, B, dtype, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
