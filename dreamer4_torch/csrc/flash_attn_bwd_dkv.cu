// Flash-attention backward, key and value gradients, for Hopper (sm_90a):
// K3 of the port.
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel` (host `flash_attend_bwd`)
// in dreamer4_tpu/ops/flash_attention.py, together with the host-side sum of
// its per-query-head partials over the GQA group. From the forward's saved
// log-sum-exp and delta = rowsum(dO * O) it recomputes, per (q, k) pair,
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
// never read (zeros in the staged tile) and get zero gradients.
//   bf16: four warps, 16 keys each, on the tensor cores (`mma.sync.m16n8k16`,
//     float32 accumulation). S^T = K Q^T and dP^T = V dO^T take A fragments
//     from the staged k and v tiles; p and ds overwrite their accumulators,
//     which are then the A fragments of P^T . dO and dS^T . Q, with the
//     B fragments of dO and Q from `ldmatrix.trans`.
//   float32: 256 threads on the float32 cores, four per key row; p and ds
//     go through shared 64 x 64 tiles to the dv and dk products.
//
// Bound. At the training slice's shape (B=27, H=8, N=M=1024, D=64, causal,
// bf16) the work is 8 D operations per visible pair (s, dp, dv, dk):
// 216 x 524,800 pairs, 58.0 GFLOP, 0.059 ms at the bf16 tensor-core peak,
// against 56.6 MB of q/dO, 113.2 MB of k/v/dk/dv and 1.8 MB of lse/delta
// (0.051 ms at 3.35 TB/s): bound by operations. This first version has no
// copy pipeline and no wgmma; its q/dO tiles are re-read from device memory
// (and L2) once per kv tile, as in the TPU kernel's grid.

#include "flash_attn_common.cuh"

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
__device__ __forceinline__ int valid_keys(int k_start, const Params& p) {
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
