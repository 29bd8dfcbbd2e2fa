// Flash-attention backward, key and value gradients, for Hopper (sm_90a):
// K3 of the port.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` (host `flash_attend_bwd`)
// in dreamer4_tpu/ops/flash_attention.py, together with the host-side sum of
// its per-query-head partials over the GQA group. From the forward's saved
// log-sum-exp and delta = rowsum(dO * O) (which K2 writes) it recomputes,
// per (q, k) pair,
//
//   s   = softclamp(scale * q . k)                     float32, as K1
//   p   = visible ? exp(s - lse) : 0                   zeroed by the mask predicate
//   dp  = dO . v
//   ds  = p * (dp - delta) * (1 - tanh^2)
//   dv  = sum over the group's query heads and queries of p . dO      (p rounded to dO's type)
//   dk  = scale * the same sum of ds . q                              (ds rounded to q's type)
//
// with the mask family of K1 (flash_attn_common.cuh).
//
// Layout: q, dO (B, Hq, N, D); k, v, dk, dv (B, H, M, D); lse, delta
// (B, Hq, N) float32; all contiguous. D is 16, 32, 64 or 128; float32 or
// bf16.
//
// Design. One block per (kv tile of 64 rows, kv head, batch) stages its k
// and v rows once, then walks the group's query heads and, for each, the q
// tiles that can see the tile: causal attention starts at the first q tile
// whose last query reaches the tile (`_block_relevant` in the other loop
// order), and a tile wholly past kv_len does no work and writes zeros. dk
// and dv stay in registers for the whole walk, so the GQA group is summed
// inside the block: no (B, Hq, M, D) partial buffer, no atomics, and the
// gradients are the same from run to run. Key rows at or past kv_len are
// never read (zeros in the staged tile) and get zero gradients. The kv
// tile index runs in launch order, so the longest causal walks start first.
//   bf16, head dims 64 and 128 (the models' path): `bwd_dkv_sm90`.
//     - One producer warp issues TMA loads (cp.async.bulk.tensor): k and v
//       once, through tensor maps that end at min(kv_len, M) (TMA writes
//       zeros for the rows past it, so a NaN there reaches no gradient),
//       then per q tile its q and dO rows through a ring of STAGES stages
//       with full and empty mbarriers. The q tile's lse and delta go into
//       the same stage by plain loads of the producer's 32 lanes, which
//       arrive on the stage's full barrier. (A tensor map cannot take them:
//       a 2-D map over (B Hq, N) floats needs N * 4 bytes a multiple of 16,
//       and a 1-D map over the flat vector, whose tiles start 16-byte
//       aligned only when N is a multiple of 4, hung the ring at N = 130.)
//     - One consumer warpgroup (4 warps, 64 key rows) computes S^T = K Q^T
//       and dP^T = V dO^T with `wgmma` from shared memory (both K-major),
//       p and ds in their accumulators, then dV += P^T dO and dK += dS^T Q
//       with P^T and dS^T as register A operands (rounded to bf16) and the
//       dO and q tiles as MN-major B operands: no transposed copy.
//     - The q tile is 32 rows: S^T and dP^T are 64 x 32 (`wgmma` m64n32).
//       Registers per consumer thread: dK + dV 64 (D = 64) or 128 (D = 128)
//       float32, S^T + dP^T 32, P and dS 16 packed, plus indices: 128 at
//       D = 64, where the compiler is held to 3 blocks per SM, about 220 at
//       D = 128 (1 block), so no setmaxnreg.
//     - Tiles wholly inside the visible region skip the mask predicate; the
//       others get the special flags of their query columns once per tile
//       (the key rows' once per block). log2(e) is folded into the LSE.
//   bf16, head dims 16 and 32 (tests only): `bwd_dkv_bf16`, four warps, 16
//     keys each, on `mma.sync.m16n8k16` from padded shared tiles: S^T and
//     dP^T take A fragments from the staged k and v tiles; p and ds
//     overwrite their accumulators, which are then the A fragments of
//     P^T . dO and dS^T . Q, with the B fragments from `ldmatrix.trans`.
//   float32: 256 threads on the float32 cores, four per key row; p and ds
//     go through shared 64 x 64 tiles to the dv and dk products.
//
// Bounds at the training shape (B=27, H=8, N=M=1024, D=64, causal, bf16;
// 113.4M visible pairs): bytes 171.6 MB (q, dO, k, v, lse, delta read; dk,
// dv written) 0.051 ms at 3.35 TB/s; tensor cores 8 D operations per pair
// (s, dp, dv, dk), 58.0 GFLOP, 0.059 ms at 989 TFLOP/s; exponential unit 2
// transcendentals per pair (tanh, exp), 0.054 ms at 16 per clock per SM x
// 132 SMs x 1.98 GHz. The tensor cores bind. As the kernel computes it, the
// softclamp costs an exponential and a reciprocal, and the diagonal tiles
// evaluate their masked halves: 3 x 120.3M special-function operations,
// 0.086 ms, the floor of this design.

#include "flash_attn_common.cuh"
#include "flash_attn_sm90.cuh"

namespace {

using namespace fa;

constexpr int BQ = 64;             // query rows per q tile
constexpr int BK = 64;             // kv rows per block

struct Params : MaskParams {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;
    const float* delta;
    void* dk;
    void* dv;
    int Hq, H;
};

// rows of this block's kv tile that hold valid keys (< kv_len and < M)
__device__ __forceinline__ int valid_keys(int k_start, const MaskParams& p) {
    return max(0, min(BK, min(p.kv_len, p.M) - k_start));
}

// the q tile's lse and delta into shared memory; rows past N get 0
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s, const Params& p,
                                           size_t q_rows, int q_start) {
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        const int qi = q_start + i;
        lse_s[i] = qi < p.N ? p.lse[q_rows + qi] : 0.f;
        delta_s[i] = qi < p.N ? p.delta[q_rows + qi] : 0.f;
    }
}

// ------------------------------------------------------------------ float32

constexpr int F32_THREADS = 256;   // 4 threads per key row
constexpr int F32_COLS = BQ / 4;   // pairs per thread per q tile

template <int D>
__global__ void __launch_bounds__(F32_THREADS) bwd_dkv_f32(const Params p) {
    constexpr int LD = D + 4;        // padded row stride of k/v/q/dO tiles
    constexpr int LDS = BQ + 4;      // padded row stride of the p and ds tiles
    constexpr int DC = D / 4;        // output columns per thread

    extern __shared__ float smem[];
    float* ks = smem;                    // BK x LD
    float* vs = ks + BK * LD;            // BK x LD
    float* qs = vs + BK * LD;            // BQ x LD
    float* dos = qs + BQ * LD;           // BQ x LD
    float* ps = dos + BQ * LD;           // BK x LDS, [key][query]
    float* dss = ps + BK * LDS;          // BK x LDS
    float* lse_s = dss + BK * LDS;       // BQ
    float* delta_s = lse_s + BQ;         // BQ

    const int k_start = blockIdx.x * BK;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int groups = p.Hq / p.H;
    const int krow = threadIdx.x >> 2;
    const int quad = threadIdx.x & 3;
    const int kj = k_start + krow;

    float dk[DC], dv[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[j] = dv[j] = 0.f;

    const int valid_k = valid_keys(k_start, p);
    if (valid_k > 0) {
        const size_t kv_off = (((size_t)b * p.H + h) * p.M + k_start) * D;
        load_f32_tile<D, LD, F32_THREADS>(ks, static_cast<const float*>(p.k) + kv_off, BK, valid_k);
        load_f32_tile<D, LD, F32_THREADS>(vs, static_cast<const float*>(p.v) + kv_off, BK, valid_k);
        const int q_lo = q_begin(k_start, BQ, p);

        for (int hq = h * groups; hq < (h + 1) * groups; ++hq) {
            const size_t q_rows = ((size_t)b * p.Hq + hq) * p.N;
            for (int q_start = q_lo; q_start < p.N; q_start += BQ) {
                const int valid_q = min(BQ, p.N - q_start);
                __syncthreads();   // previous q tile fully consumed
                load_f32_tile<D, LD, F32_THREADS>(
                    qs, static_cast<const float*>(p.q) + (q_rows + q_start) * D, BQ, valid_q);
                load_f32_tile<D, LD, F32_THREADS>(
                    dos, static_cast<const float*>(p.dout) + (q_rows + q_start) * D, BQ, valid_q);
                load_stats(lse_s, delta_s, p, q_rows, q_start);
                __syncthreads();

                // s and dp for queries quad + 4 * j
                float s[F32_COLS], dp[F32_COLS];
#pragma unroll
                for (int j = 0; j < F32_COLS; ++j) s[j] = dp[j] = 0.f;
                const float* kr = ks + krow * LD;
                const float* vr = vs + krow * LD;
#pragma unroll 2
                for (int d = 0; d < D; d += 4) {
                    const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
                    const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
                    for (int j = 0; j < F32_COLS; ++j) {
                        const float4 q4 = *reinterpret_cast<const float4*>(qs + (quad + 4 * j) * LD + d);
                        const float4 g4 = *reinterpret_cast<const float4*>(dos + (quad + 4 * j) * LD + d);
                        s[j] = fmaf(k4.x, q4.x, fmaf(k4.y, q4.y, fmaf(k4.z, q4.z, fmaf(k4.w, q4.w, s[j]))));
                        dp[j] = fmaf(v4.x, g4.x, fmaf(v4.y, g4.y, fmaf(v4.z, g4.z, fmaf(v4.w, g4.w, dp[j]))));
                    }
                }
                float* prow = ps + krow * LDS;
                float* dsrow = dss + krow * LDS;
#pragma unroll
                for (int j = 0; j < F32_COLS; ++j) {
                    const int c = quad + 4 * j;
                    const int qi = q_start + c;
                    const bool q_special = p.num_special > 0 && is_special(qi + p.offset, p);
                    float dscore;
                    const float x = clamp_score(s[j], p, dscore);
                    const bool ok = visible(qi, q_special, kj, p);
                    const float pr = ok ? __expf(x - lse_s[c]) : 0.f;
                    prow[c] = pr;
                    dsrow[c] = ok ? pr * (dp[j] - delta_s[c]) * dscore : 0.f;
                }
                __syncthreads();   // the row's p and ds are written by 4 threads

                // dv[c], dk[c] cover columns 4 * quad + 16 * (c / 4) + c % 4
                for (int c = 0; c < BQ; ++c) {
                    const float pc = prow[c];
                    const float dsc = dsrow[c];
                    const float* gr = dos + c * LD + 4 * quad;
                    const float* qr = qs + c * LD + 4 * quad;
#pragma unroll
                    for (int j = 0; j < DC / 4; ++j) {
                        const float4 g4 = *reinterpret_cast<const float4*>(gr + 16 * j);
                        const float4 q4 = *reinterpret_cast<const float4*>(qr + 16 * j);
                        dv[4 * j + 0] = fmaf(pc, g4.x, dv[4 * j + 0]);
                        dv[4 * j + 1] = fmaf(pc, g4.y, dv[4 * j + 1]);
                        dv[4 * j + 2] = fmaf(pc, g4.z, dv[4 * j + 2]);
                        dv[4 * j + 3] = fmaf(pc, g4.w, dv[4 * j + 3]);
                        dk[4 * j + 0] = fmaf(dsc, q4.x, dk[4 * j + 0]);
                        dk[4 * j + 1] = fmaf(dsc, q4.y, dk[4 * j + 1]);
                        dk[4 * j + 2] = fmaf(dsc, q4.z, dk[4 * j + 2]);
                        dk[4 * j + 3] = fmaf(dsc, q4.w, dk[4 * j + 3]);
                    }
                }
            }
        }
    }

    if (kj < p.M) {
        const size_t out = (((size_t)b * p.H + h) * p.M + kj) * D;
        float* dkrow = static_cast<float*>(p.dk) + out;
        float* dvrow = static_cast<float*>(p.dv) + out;
#pragma unroll
        for (int j = 0; j < DC / 4; ++j) {
            *reinterpret_cast<float4*>(dkrow + 4 * quad + 16 * j) =
                make_float4(dk[4 * j] * p.scale, dk[4 * j + 1] * p.scale,
                            dk[4 * j + 2] * p.scale, dk[4 * j + 3] * p.scale);
            *reinterpret_cast<float4*>(dvrow + 4 * quad + 16 * j) =
                make_float4(dv[4 * j], dv[4 * j + 1], dv[4 * j + 2], dv[4 * j + 3]);
        }
    }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
    constexpr int LD = D + 4;
    constexpr int LDS = BQ + 4;
    const size_t smem = sizeof(float) * (2 * (size_t)BK * LD + 2 * (size_t)BQ * LD
                                         + 2 * (size_t)BK * LDS + 2 * (size_t)BQ);
    cudaError_t err = cudaFuncSetAttribute(bwd_dkv_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.M + BK - 1) / BK, p.H, B);
    bwd_dkv_f32<D><<<grid, F32_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// --------------------------------------------------------------------- bf16

constexpr int BF16_THREADS = 128;  // 4 warps x 16 keys

template <int D>
__global__ void __launch_bounds__(BF16_THREADS) bwd_dkv_bf16(const Params p) {
    constexpr int LD = D + 8;        // bf16 row stride of the tiles (16-byte pad)
    constexpr int KSTEPS = D / 16;   // mma k-steps over the head dim
    constexpr int NB_Q = BQ / 8;     // 8-query column blocks of a transposed score tile
    constexpr int NB_O = D / 8;      // 8-column blocks of dk and dv

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // BK x LD
    bf16* vs = ks + BK * LD;                        // BK x LD
    bf16* qs = vs + BK * LD;                        // BQ x LD
    bf16* dos = qs + BQ * LD;                       // BQ x LD
    float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);   // BQ
    float* delta_s = lse_s + BQ;                              // BQ

    const int k_start = blockIdx.x * BK;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int groups = p.Hq / p.H;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;                          // fragment row group
    const int t = lane & 3;                           // fragment column pair
    const int w_row = (threadIdx.x >> 5) * 16;        // the warp's first key row
    const int kj[2] = {k_start + w_row + g, k_start + w_row + g + 8};

    float dk[NB_O][4], dv[NB_O][4];  // [nb][2r + e]: key row g + 8r, column 8nb + 2t + e
#pragma unroll
    for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.f;
    }

    const int valid_k = valid_keys(k_start, p);
    if (valid_k > 0) {
        const size_t kv_off = (((size_t)b * p.H + h) * p.M + k_start) * D;
        load_bf16_tile<D, LD, BF16_THREADS>(ks, static_cast<const bf16*>(p.k) + kv_off, BK, valid_k);
        load_bf16_tile<D, LD, BF16_THREADS>(vs, static_cast<const bf16*>(p.v) + kv_off, BK, valid_k);
        const int q_lo = q_begin(k_start, BQ, p);

        for (int hq = h * groups; hq < (h + 1) * groups; ++hq) {
            const size_t q_rows = ((size_t)b * p.Hq + hq) * p.N;
            for (int q_start = q_lo; q_start < p.N; q_start += BQ) {
                const int valid_q = min(BQ, p.N - q_start);
                __syncthreads();   // previous q tile fully consumed (and k/v staged)
                load_bf16_tile<D, LD, BF16_THREADS>(
                    qs, static_cast<const bf16*>(p.q) + (q_rows + q_start) * D, BQ, valid_q);
                load_bf16_tile<D, LD, BF16_THREADS>(
                    dos, static_cast<const bf16*>(p.dout) + (q_rows + q_start) * D, BQ, valid_q);
                load_stats(lse_s, delta_s, p, q_rows, q_start);
                __syncthreads();

                // s[nb][2r + e], dp[nb][2r + e]: key row g + 8r, query q_start + 8nb + 2t + e
                float s[NB_Q][4], dp[NB_Q][4];
#pragma unroll
                for (int nb = 0; nb < NB_Q; ++nb) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
                }
#pragma unroll
                for (int st = 0; st < KSTEPS; ++st) {
                    uint32_t kf[4], vf[4];
                    load_a_frag<LD>(kf, ks, w_row, st * 16, g, t);
                    load_a_frag<LD>(vf, vs, w_row, st * 16, g, t);
#pragma unroll
                    for (int nb = 0; nb < NB_Q; ++nb) {
                        uint32_t qf[2], gf[2];
                        load_b_frag<LD>(qf, qs, nb * 8, st * 16, g, t);
                        load_b_frag<LD>(gf, dos, nb * 8, st * 16, g, t);
                        mma_16816(s[nb], kf, qf);
                        mma_16816(dp[nb], vf, gf);
                    }
                }

                // p into s, ds into dp
#pragma unroll
                for (int nb = 0; nb < NB_Q; ++nb) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int c = nb * 8 + 2 * t + (e & 1);
                        const int qi = q_start + c;
                        const bool q_special = p.num_special > 0 && is_special(qi + p.offset, p);
                        float dscore;
                        const float x = clamp_score(s[nb][e], p, dscore);
                        const bool ok = visible(qi, q_special, kj[e >> 1], p);
                        const float pr = ok ? __expf(x - lse_s[c]) : 0.f;
                        dp[nb][e] = ok ? pr * (dp[nb][e] - delta_s[c]) * dscore : 0.f;
                        s[nb][e] = pr;
                    }
                }

                // dv += P^T . dO (p rounded to bf16), dk += dS^T . Q (ds rounded to bf16)
#pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk) {
                    uint32_t pf[4], dsf[4];
                    acc_to_a_frag(pf, s[2 * kk], s[2 * kk + 1]);
                    acc_to_a_frag(dsf, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
                    for (int nb = 0; nb < NB_O; ++nb) {
                        uint32_t gf[2], qf[2];
                        ldmatrix_x2_trans(gf, dos + (kk * 16 + (lane & 15)) * LD + nb * 8);
                        ldmatrix_x2_trans(qf, qs + (kk * 16 + (lane & 15)) * LD + nb * 8);
                        mma_16816(dv[nb], pf, gf);
                        mma_16816(dk[nb], dsf, qf);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (kj[r] >= p.M) continue;
        const size_t out = (((size_t)b * p.H + h) * p.M + kj[r]) * D;
        bf16* dkrow = static_cast<bf16*>(p.dk) + out;
        bf16* dvrow = static_cast<bf16*>(p.dv) + out;
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            *reinterpret_cast<uint32_t*>(dkrow + nb * 8 + 2 * t) =
                pack_bf16x2(dk[nb][2 * r] * p.scale, dk[nb][2 * r + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(dvrow + nb * 8 + 2 * t) =
                pack_bf16x2(dv[nb][2 * r], dv[nb][2 * r + 1]);
        }
    }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
    constexpr int LD = D + 8;
    const size_t smem = sizeof(bf16) * (size_t)(2 * BK + 2 * BQ) * LD + 2 * sizeof(float) * BQ;
    cudaError_t err = cudaFuncSetAttribute(bwd_dkv_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.M + BK - 1) / BK, p.H, B);
    bwd_dkv_bf16<D><<<grid, BF16_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// ------------------------------------- bf16, head dims 64 and 128: Hopper

constexpr int SM90_THREADS = 160;  // one consumer warpgroup + one producer warp
constexpr int STAGES = 2;          // q/dO/lse/delta ring depth (3 and 4 were no faster)
constexpr int SM90_BQ = 32;        // q rows per streamed tile

// Blocks per SM the compiler must fit: 3 at D = 64 caps a thread at 128
// registers (no spills with 32-row q tiles); 64-row q tiles took 202
// registers, 2 blocks per SM, and 1.4x the time at the training shape on
// an H100.
// D = 128 needs about 220 registers: 1 block.
constexpr int sm90_min_blocks(int D) { return D == 64 ? 3 : 1; }

struct Sm90Params : MaskParams {
    CUtensorMap k, v;              // (B * H, min(kv_len, M), D), boxes of 64 rows
    CUtensorMap q, dout;           // (B * Hq, N, D), boxes of the q tile's rows
    const float* lse;
    const float* delta;
    bf16* dk;
    bf16* dv;
    int Hq, H;
};

// byte offsets in the block's shared memory (from a 1024-byte aligned base)
template <int D>
struct Sm90Layout {
    static constexpr int BQ = SM90_BQ;
    static constexpr int KTILE = BK * D * 2, KSLAB = BK * 128;
    static constexpr int QTILE = BQ * D * 2, QSLAB = BQ * 128;
    static constexpr int K = 0, V = KTILE;
    static constexpr int Q = 2 * KTILE, DO = Q + STAGES * QTILE;
    static constexpr int LSE = DO + STAGES * QTILE, DELTA = LSE + STAGES * BQ * 4;
    static constexpr int BARS = DELTA + STAGES * BQ * 4;   // full, empty (STAGES each), resident
    static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;   // + alignment slack
};

// P^T and dS^T of a 64-key x BQ-query tile as the A fragments of dV +=
// P^T dO and dK += dS^T Q, in one pass (two passes, through p * (1 -
// tanh^2) kept in the score registers, spilled at the 128-register cap):
// pf[kk], dsf[kk] hold queries 16 kk .. 16 kk + 15 (s[4j + 2r + e]: key row
// g + 8r, query q0 + 8j + e, whose lse and delta are lse_s[8j + 2t + e] and
// delta_s[...]). Without MASKED every pair is visible.
template <int BQ, bool MASKED, bool CLAMP>
__device__ __forceinline__ void p_ds_fragments(uint32_t (&pf)[BQ / 16][4],
                                               uint32_t (&dsf)[BQ / 16][4],
                                               const float (&s)[BQ / 2], const float (&dp)[BQ / 2],
                                               const float* lse_s, const float* delta_s, int t,
                                               const int (&kj)[2], const bool (&k_sp)[2], int q0,
                                               uint32_t q_sp, const MaskParams& p) {
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
        const float lse2[2] = {l2.x * LOG2E, l2.y * LOG2E};
        const float delta[2] = {d2.x, d2.y};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float pr[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int idx = 4 * j + 2 * r + e;
                float dscore;
                pr[e] = backward_p<CLAMP>(s[idx], lse2[e], p, dscore);
                ds[e] = pr[e] * (dp[idx] - delta[e]) * dscore;
                if (MASKED && !visible_given(q0 + 8 * j + e, (q_sp >> (2 * j + e)) & 1u, kj[r],
                                             k_sp[r], p)) {
                    pr[e] = ds[e] = 0.f;
                }
            }
            pf[j >> 1][(j & 1) * 2 + r] = pack_bf16x2(pr[0], pr[1]);
            dsf[j >> 1][(j & 1) * 2 + r] = pack_bf16x2(ds[0], ds[1]);
        }
    }
}

template <int D, bool CLAMP>
__global__ void __launch_bounds__(SM90_THREADS, sm90_min_blocks(D))
    bwd_dkv_sm90(const __grid_constant__ Sm90Params p) {
    using namespace sm90;
    using L = Sm90Layout<D>;
    constexpr int BQ = L::BQ;
    constexpr int NS = D / 64;       // slabs per row
    constexpr uint32_t SBO = 1024;   // bytes per 8-row group of a slab

    extern __shared__ __align__(1024) uint8_t sm90_smem[];
    uint8_t* sm = align_1024(sm90_smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
    uint64_t* empty = full + STAGES;
    uint64_t* resident = empty + STAGES;

    const int k_start = blockIdx.x * BK;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int groups = p.Hq / p.H;
    const int bh = b * p.H + h;
    const int q_lo = q_begin(k_start, BQ, p);
    const int n_q = valid_keys(k_start, p) > 0 && q_lo < p.N ? (p.N - q_lo + BQ - 1) / BQ : 0;
    const int n_tiles = groups * n_q;    // (query head, q tile) pairs the block walks
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1 + 32);   // the TMA's expect_tx, then each producer lane
            mbar_init(&empty[s], 4);       // one arrival per consumer warp
        }
        mbar_init(resident, 1);
        fence_barrier_init();
    }
    __syncthreads();

    if (warp == 4) {   // producer: k, v once, then the q tiles through the ring
        if (n_tiles == 0) return;
        if (lane == 0) {
            mbar_expect_tx(resident, 2 * L::KTILE);
            for (int s = 0; s < NS; ++s) {
                tma_load_3d(sm + L::K + s * L::KSLAB, &p.k, resident, 64 * s, k_start, bh);
                tma_load_3d(sm + L::V + s * L::KSLAB, &p.v, resident, 64 * s, k_start, bh);
            }
        }
        for (int i = 0; i < n_tiles; ++i) {
            const int st = i % STAGES;
            const int bhq = b * p.Hq + h * groups + i / n_q;
            const int q_start = q_lo + (i % n_q) * BQ;
            // lse and delta by plain loads (see the note at the top), issued
            // before the wait for the stage
            const size_t row0 = (size_t)bhq * p.N + q_start;
            float lse_v[BQ / 32], delta_v[BQ / 32];
#pragma unroll
            for (int c = 0; c < BQ / 32; ++c) {
                const bool in = q_start + lane + 32 * c < p.N;
                lse_v[c] = in ? p.lse[row0 + lane + 32 * c] : 0.f;
                delta_v[c] = in ? p.delta[row0 + lane + 32 * c] : 0.f;
            }
            mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
            if (lane == 0) {
                mbar_expect_tx(&full[st], 2 * L::QTILE);
                for (int s = 0; s < NS; ++s) {
                    tma_load_3d(sm + L::Q + st * L::QTILE + s * L::QSLAB, &p.q, &full[st], 64 * s,
                                q_start, bhq);
                    tma_load_3d(sm + L::DO + st * L::QTILE + s * L::QSLAB, &p.dout, &full[st],
                                64 * s, q_start, bhq);
                }
            }
            float* lse_s = reinterpret_cast<float*>(sm + L::LSE + st * BQ * 4);
            float* delta_s = reinterpret_cast<float*>(sm + L::DELTA + st * BQ * 4);
#pragma unroll
            for (int c = 0; c < BQ / 32; ++c) {
                lse_s[lane + 32 * c] = lse_v[c];
                delta_s[lane + 32 * c] = delta_v[c];
            }
            mbar_arrive(&full[st]);
        }
        return;
    }

    // consumer warpgroup: warp w owns key rows 16 w .. 16 w + 15
    const int g = lane >> 2;
    const int t = lane & 3;
    const int w_row = warp * 16;
    int kj[2];
    bool k_sp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        kj[r] = k_start + w_row + g + 8 * r;
        k_sp[r] = p.num_special > 0 && is_special(kj[r], p);
    }

    float dk[NS][32], dv[NS][32];    // [s][4j + 2r + e]: key row g + 8r, column 64 s + 8j + 2t + e
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int i = 0; i < 32; ++i) dk[s][i] = dv[s][i] = 0.f;
    }
    if (n_tiles > 0) mbar_wait(resident, 0);

    for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        const int q_start = q_lo + (i % n_q) * BQ;
        const uint8_t* qt = sm + L::Q + st * L::QTILE;
        const uint8_t* dot = sm + L::DO + st * L::QTILE;
        const float* lse_s = reinterpret_cast<const float*>(sm + L::LSE + st * BQ * 4);
        const float* delta_s = reinterpret_cast<const float*>(sm + L::DELTA + st * BQ * 4);
        mbar_wait(&full[st], (i / STAGES) & 1);

        // S^T = K Q^T, dP^T = V dO^T. (Committing dP^T apart, to compute p
        // and start dV while it runs, needed more registers than the cap of
        // 128: it spilled and ran slower.)
        float s_acc[BQ / 2], dp_acc[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const int a_off = (kk / 4) * L::KSLAB + (kk % 4) * 32;
            const int b_off = (kk / 4) * L::QSLAB + (kk % 4) * 32;
            wgmma_ss_n32(s_acc, sw128_desc(sm + L::K + a_off, 16, SBO),
                         sw128_desc(qt + b_off, 16, SBO), kk > 0);
            wgmma_ss_n32(dp_acc, sw128_desc(sm + L::V + a_off, 16, SBO),
                         sw128_desc(dot + b_off, 16, SBO), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s_acc);
        fence_regs(dp_acc);

        uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
        if (tile_all_visible(q_start, BQ, k_start, BK, p)) {
            p_ds_fragments<BQ, false, CLAMP>(pf, dsf, s_acc, dp_acc, lse_s, delta_s, t, kj, k_sp, 0,
                                             0u, p);
        } else {
            const int q0 = q_start + 2 * t;
            // special flags of the thread's query columns
            const uint32_t q_sp = p.num_special > 0 ? special_bits<BQ / 8>(q0 + p.offset, p) : 0u;
            p_ds_fragments<BQ, true, CLAMP>(pf, dsf, s_acc, dp_acc, lse_s, delta_s, t, kj, k_sp, q0,
                                            q_sp, p);
        }

        // dV += P^T dO, dK += dS^T Q: the dO and q tiles MN-major (their
        // rows are the reduced queries)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            fence_regs(dk[s]);
            fence_regs(dv[s]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                const int off = s * L::QSLAB + kk * 16 * 128;
                wgmma_rs_n64_mn(dv[s], pf[kk], sw128_desc(dot + off, L::QSLAB, SBO));
                wgmma_rs_n64_mn(dk[s], dsf[kk], sw128_desc(qt + off, L::QSLAB, SBO));
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            fence_regs(dk[s]);
            fence_regs(dv[s]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (kj[r] >= p.M) continue;
        const size_t out = ((size_t)bh * p.M + kj[r]) * D;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int c = 64 * s + 8 * j + 2 * t;
                *reinterpret_cast<uint32_t*>(p.dk + out + c) = pack_bf16x2(
                    dk[s][4 * j + 2 * r] * p.scale, dk[s][4 * j + 2 * r + 1] * p.scale);
                *reinterpret_cast<uint32_t*>(p.dv + out + c) =
                    pack_bf16x2(dv[s][4 * j + 2 * r], dv[s][4 * j + 2 * r + 1]);
            }
        }
    }
}

template <int D, bool CLAMP>
cudaError_t launch_sm90_as(const Sm90Params& p, int B, cudaStream_t stream) {
    constexpr int smem = Sm90Layout<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(bwd_dkv_sm90<D, CLAMP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.M + BK - 1) / BK, p.H, B);
    bwd_dkv_sm90<D, CLAMP><<<grid, SM90_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_sm90(const Params& in, int B, cudaStream_t stream) {
    constexpr int BQ = Sm90Layout<D>::BQ;
    Sm90Params p;
    static_cast<MaskParams&>(p) = in;
    const int kv_rows = max(1, min(in.kv_len, in.M));
    const bool maps =
        sm90::make_rows_map(&p.k, in.k, D, in.M, kv_rows, B * in.H, BK) &&
        sm90::make_rows_map(&p.v, in.v, D, in.M, kv_rows, B * in.H, BK) &&
        sm90::make_rows_map(&p.q, in.q, D, in.N, in.N, B * in.Hq, BQ) &&
        sm90::make_rows_map(&p.dout, in.dout, D, in.N, in.N, B * in.Hq, BQ);
    if (!maps) return cudaErrorInvalidValue;
    p.lse = in.lse;
    p.delta = in.delta;
    p.dk = static_cast<bf16*>(in.dk);
    p.dv = static_cast<bf16*>(in.dv);
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
// softclamp <= 0 means no softclamp. Returns the CUDA error code of the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv,
                                  int B, int Hq, int H, int N, int M, int D, int dtype, int offset,
                                  int kv_len, float scale, float softclamp, int causal,
                                  int num_special, int special_seq_len, int special_only_itself,
                                  void* stream) {
    if (B <= 0 || Hq <= 0 || H <= 0 || N <= 0 || M <= 0 || Hq % H != 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;   // grid y, z limits
    if (num_special > 0 && special_seq_len <= 0) return (int)cudaErrorInvalidValue;
    Params p;
    static_cast<MaskParams&>(p) = make_mask_params(N, M, offset, kv_len, scale, softclamp, causal,
                                                   num_special, special_seq_len,
                                                   special_only_itself);
    p.q = q;
    p.k = k;
    p.v = v;
    p.dout = dout;
    p.lse = lse;
    p.delta = delta;
    p.dk = dk;
    p.dv = dv;
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
