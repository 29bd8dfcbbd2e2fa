// Flash-attention backward, query gradient, for Hopper (sm_90a): K2 of the port.
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel` (host `flash_attend_bwd`)
// in dreamer4_tpu/ops/flash_attention.py. From the forward's saved
// log-sum-exp and delta = rowsum(dO * O) it recomputes, per (q, k) pair,
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
// Layout: q, dO, dq (B, Hq, N, D); k, v (B, H, M, D); lse, delta (B, Hq, N)
// float32; all contiguous. D is 16, 32, 64 or 128; float32 or bf16.
//
// Design. One block per (q tile of 64 rows, q head, batch) walks the kv
// tiles of 64 rows that the tile can see (the same end as K1: tiles past
// kv_len or above the causal diagonal are never read) and keeps dq in
// registers; nothing is carried between blocks, so there are no atomics.
//   bf16: four warps, 16 query rows each, on the tensor cores
//     (`mma.sync.m16n8k16`, float32 accumulation). S = Q K^T and dP = dO V^T
//     take their A fragments from the staged Q and dO tiles; ds overwrites
//     the score accumulators, which are then the A fragments of ds . K,
//     with K's B fragments from `ldmatrix.trans`.
//   float32: 256 threads on the float32 cores, four per query row; ds goes
//     through a shared 64 x 64 tile to the dq product.
//
// Bound. At the training slice's shape (B=27, H=8, N=M=1024, D=64, causal,
// bf16) the work is 6 D operations per visible pair (s, dp, dq):
// 216 x 524,800 pairs, 43.5 GFLOP, 0.044 ms at the bf16 tensor-core peak,
// against 2 x 28.3 MB of q/dO, 28.3 MB of dq, 56.6 MB of k/v and 1.8 MB of
// lse/delta (0.043 ms at 3.35 TB/s): bound by operations, barely. This first
// version has no copy pipeline (plain 16-byte loads, no cp.async or TMA),
// recomputes s once per pair as the TPU kernel does, and leaves the wgmma
// and the overlap of loads with math to a later version.

#include "flash_attn_common.cuh"

namespace {

using namespace fa;

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // kv rows per tile

struct Params : MaskParams {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;
    const float* delta;
    void* dq;
    int Hq, H;
};

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
    const float lse = qi < p.N ? p.lse[q_rows + qi] : 0.f;
    const float delta = qi < p.N ? p.delta[q_rows + qi] : 0.f;
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
                                         + (size_t)BQ * LDS);
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BQ - 1) / BQ, p.Hq, B);
    bwd_dq_f32<D><<<grid, F32_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

// --------------------------------------------------------------------- bf16

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
    float lse[2], delta[2];
    bool q_special[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        lse[r] = qi[r] < p.N ? p.lse[q_rows + qi[r]] : 0.f;
        delta[r] = qi[r] < p.N ? p.delta[q_rows + qi[r]] : 0.f;
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
    const size_t smem = sizeof(bf16) * (size_t)(2 * BQ + 2 * BK) * LD;
    cudaError_t err = cudaFuncSetAttribute(bwd_dq_bf16<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.N + BQ - 1) / BQ, p.Hq, B);
    bwd_dq_bf16<D><<<grid, BF16_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int B, int dtype, cudaStream_t stream) {
    if (dtype == 0) return launch_f32<D>(p, B, stream);
    if (dtype == 1) return launch_bf16<D>(p, B, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16.
// softclamp <= 0 means no softclamp. Returns the CUDA error code of the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq,
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
