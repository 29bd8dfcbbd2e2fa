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
//
// Design. One block per (q tile of 64 rows, q head, batch) walks the kv
// tiles of 64 rows in order, stages each in shared memory and keeps the
// running max, sum and output accumulator of its rows in registers. Tiles
// wholly beyond kv_len or above the causal diagonal are never loaded; ragged
// N and M edges are masked inside the kernel. As in the TPU kernel, the
// probabilities are rounded to the input type before the PV product and the
// row sum uses them unrounded. The TPU kernel's blocking (128-lane LSE
// padding, D padded to 128) is not carried over.
//   bf16: four warps, 16 query rows each, on the tensor cores
//     (`mma.sync.m16n8k16`, float32 accumulation). Q stays in registers as
//     A fragments; the score accumulators are reused as the A fragments of
//     the PV product, so P never leaves registers; V's B fragments come
//     from the row-major tile through `ldmatrix.trans`.
//   float32: 256 threads on the float32 cores, four threads per query row,
//     the tiles staged as float32 (the tensor cores have no float32 mode
//     that keeps the reference's precision).
//
// Bound. At the rollout's prefill shape (B=432, H=8, N=96, M=192, D=64,
// bf16, causal, kv_len=96) the kernel must read q and the 96 valid k/v rows
// and write o: 4 x 42.5 MB = 170 MB, 51 us at 3.35 TB/s, against 4.1 GFLOP
// of causal score and PV work (4 us at the bf16 tensor-core peak). So it is
// bound by bytes: the design reads each q/k/v element once per block from
// device memory and keeps scores and probabilities out of it. Loads are
// plain 16-byte loads without a copy pipeline (cp.async or TMA); occupancy
// alone hides their latency.

#include "flash_attn_common.cuh"

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

template <int D>
cudaError_t launch(const Params& p, int B, int dtype, cudaStream_t stream) {
    if (dtype == 0) return launch_f32<D>(p, B, stream);
    if (dtype == 1) return launch_bf16<D>(p, B, stream);
    return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16.
// softclamp <= 0 means no softclamp. lse may be null. Returns the CUDA error
// code of the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
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
    p.o = o;
    p.lse = lse;
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
