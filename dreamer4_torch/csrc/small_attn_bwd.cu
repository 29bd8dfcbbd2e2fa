// Small-attention backward for Hopper (sm_90a): K5 of the port.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (host `_bwd_host`, under the
// custom VJP of `_small_attend_flat`) in dreamer4_tpu/ops/small_attention.py.
// From q, k, v and the output gradient dO alone (no saved LSE) it
// recomputes, per (batch row, head),
//
//   s, t = scale * q . k, tanh(s / c)          float32, softclamp as K4
//   p    = softmax(mask ? c * t : -1e30)       float32, normalized
//   dp   = dO . v^T
//   ds   = p * (dp - rowsum(dp * p)) * (1 - t^2) * scale, rounded to q's type
//   dq   = ds . k,  dk = ds^T . q,  dv = round(p)^T . dO
//
// with float32 sums and each gradient written in its input's type: the TPU
// kernel's rounding points (p rounded to v's type before dv).
//
// Layout: q, k, v, dO, dq, dk, dv (B, n*h, D) contiguous, the flat layout of
// K4; mask a (n, n) uint8 table or null. n <= 64; D is 16, 32, 64 or 128;
// float32 or bf16.
//
// Design. One block owns one (batch row, head), so it writes dq, dk and dv
// of that head itself: no atomics and no partial buffers, and the gradients
// are the same from run to run. It stages q, k, v and dO (n padded to NPAD
// rows, zero-filled, never read past n) in shared memory, recomputes S and
// P as K4 does, and keeps the products in registers.
//   bf16: NPAD / 16 warps on the tensor cores (`mma.sync.m16n8k16`, float32
//     accumulation). Each warp takes 16 query rows: S = Q K^T and
//     dP = dO V^T, then p and ds in place in the accumulators, which are
//     the A fragments of dQ = dS K (K's B fragments by `ldmatrix.trans`).
//     p and ds also go to shared memory transposed, [key][query], so that
//     after one barrier each warp takes 16 key rows for dK = dS^T Q and
//     dV = P^T dO, the sums over queries that cross warps.
//   float32: four threads per row on the float32 cores; p and ds go
//     through shared memory [query][key] to the dq (by query row) and dk/dv
//     (by key row) sums.
// Padded query rows have p and ds set to 0; padded keys score -inf, so their
// p and ds are 0 as well.
//
// Bound. At the tokenizer's time layer (B = 640, n = 16, h = 8, D = 64,
// bf16, causal) the kernel reads q, k, v, dO and writes dq, dk, dv: 7 x
// 10.5 MB, 22 us at 3.35 TB/s, against 0.9 GFLOP of per-head products
// (s, dp, dq, dk, dv; about 1 us at the bf16 peak). So it is bound by bytes,
// like K4: each element is read once and each gradient written once.

#include "small_attn_common.cuh"

namespace {

using namespace sa;
using fa::NEG_INF;

// ------------------------------------------------------------------ float32

template <int D, int NT>
__global__ void __launch_bounds__(64 * NT) small_bwd_f32(const Params p) {
    constexpr int NPAD = 16 * NT;
    constexpr int THREADS = 4 * NPAD;    // four threads per row
    constexpr int LD = D + 4;            // padded row stride of the q/k/v/dO tiles
    constexpr int LDP = NPAD + 4;        // row stride of the p and ds tiles
    constexpr int COLS = NPAD / 4;       // keys per thread
    constexpr int DC = D / 4;            // gradient columns per thread

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qs = reinterpret_cast<float*>(smem_raw);   // NPAD x LD
    float* ks = qs + NPAD * LD;
    float* vs = ks + NPAD * LD;
    float* dos = vs + NPAD * LD;
    float* ps = dos + NPAD * LD;                       // NPAD x LDP, [query][key]
    float* dss = ps + NPAD * LDP;
    uint8_t* ms = reinterpret_cast<uint8_t*>(dss + NPAD * LDP);

    const int b = blockIdx.x / p.h;
    const int hh = blockIdx.x % p.h;
    const size_t stride = (size_t)p.h * D;
    const size_t base = head_base<D>(b, hh, p);
    load_head_f32<D, LD, THREADS>(qs, static_cast<const float*>(p.q) + base, stride, NPAD, p.n);
    load_head_f32<D, LD, THREADS>(ks, static_cast<const float*>(p.k) + base, stride, NPAD, p.n);
    load_head_f32<D, LD, THREADS>(vs, static_cast<const float*>(p.v) + base, stride, NPAD, p.n);
    load_head_f32<D, LD, THREADS>(dos, static_cast<const float*>(p.dout) + base, stride, NPAD, p.n);
    stage_mask<NPAD, THREADS>(ms, p);
    __syncthreads();

    const int row = threadIdx.x >> 2;
    const int quad = threadIdx.x & 3;

    // scores and dp for keys quad + 4 * j
    float s[COLS], dp[COLS], dsc[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[j] = dp[j] = 0.f;
    const float* qrow = qs + row * LD;
    const float* grow = dos + row * LD;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + d);
        const float4 g4 = *reinterpret_cast<const float4*>(grow + d);
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const float4 k4 = *reinterpret_cast<const float4*>(ks + (quad + 4 * j) * LD + d);
            const float4 v4 = *reinterpret_cast<const float4*>(vs + (quad + 4 * j) * LD + d);
            s[j] = fmaf(q4.x, k4.x, fmaf(q4.y, k4.y, fmaf(q4.z, k4.z, fmaf(q4.w, k4.w, s[j]))));
            dp[j] = fmaf(g4.x, v4.x, fmaf(g4.y, v4.y, fmaf(g4.z, v4.z, fmaf(g4.w, v4.w, dp[j]))));
        }
    }

    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
        s[j] = small_score<NPAD>(s[j], row, quad + 4 * j, ms, p, dsc[j]);
        mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
        s[j] = __expf(s[j] - mx);
        sum += s[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    float dot = 0.f;   // rowsum(dp * p)
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
        s[j] = row < p.n ? s[j] / sum : 0.f;
        dot += dp[j] * s[j];
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    float* prow = ps + row * LDP;
    float* dsrow = dss + row * LDP;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
        prow[quad + 4 * j] = s[j];
        dsrow[quad + 4 * j] = s[j] * (dp[j] - dot) * dsc[j] * p.clamp.scale;
    }
    __syncthreads();   // the p and ds tiles are read by every row below

    // dq: this thread's row as a query; dk, dv: the same row as a key.
    // acc[4j + c]: column 4 * quad + 16 * j + c
    float dq[DC], dk[DC], dv[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) dq[j] = dk[j] = dv[j] = 0.f;
    for (int c = 0; c < p.n; ++c) {
        const float ds_qc = dsrow[c];                   // ds[row][c]
        const float ds_cr = dss[c * LDP + row];         // ds[c][row]
        const float p_cr = ps[c * LDP + row];           // p[c][row]
        const float* krow = ks + c * LD + 4 * quad;
        const float* qr = qs + c * LD + 4 * quad;
        const float* gr = dos + c * LD + 4 * quad;
#pragma unroll
        for (int j = 0; j < DC / 4; ++j) {
            const float4 k4 = *reinterpret_cast<const float4*>(krow + 16 * j);
            const float4 q4 = *reinterpret_cast<const float4*>(qr + 16 * j);
            const float4 g4 = *reinterpret_cast<const float4*>(gr + 16 * j);
            dq[4 * j + 0] = fmaf(ds_qc, k4.x, dq[4 * j + 0]);
            dq[4 * j + 1] = fmaf(ds_qc, k4.y, dq[4 * j + 1]);
            dq[4 * j + 2] = fmaf(ds_qc, k4.z, dq[4 * j + 2]);
            dq[4 * j + 3] = fmaf(ds_qc, k4.w, dq[4 * j + 3]);
            dk[4 * j + 0] = fmaf(ds_cr, q4.x, dk[4 * j + 0]);
            dk[4 * j + 1] = fmaf(ds_cr, q4.y, dk[4 * j + 1]);
            dk[4 * j + 2] = fmaf(ds_cr, q4.z, dk[4 * j + 2]);
            dk[4 * j + 3] = fmaf(ds_cr, q4.w, dk[4 * j + 3]);
            dv[4 * j + 0] = fmaf(p_cr, g4.x, dv[4 * j + 0]);
            dv[4 * j + 1] = fmaf(p_cr, g4.y, dv[4 * j + 1]);
            dv[4 * j + 2] = fmaf(p_cr, g4.z, dv[4 * j + 2]);
            dv[4 * j + 3] = fmaf(p_cr, g4.w, dv[4 * j + 3]);
        }
    }
    if (row < p.n) {
        const size_t off = base + row * stride + 4 * quad;
        float* dqrow = static_cast<float*>(p.o) + off;
        float* dkrow = static_cast<float*>(p.dk) + off;
        float* dvrow = static_cast<float*>(p.dv) + off;
#pragma unroll
        for (int j = 0; j < DC / 4; ++j) {
            *reinterpret_cast<float4*>(dqrow + 16 * j) =
                make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
            *reinterpret_cast<float4*>(dkrow + 16 * j) =
                make_float4(dk[4 * j], dk[4 * j + 1], dk[4 * j + 2], dk[4 * j + 3]);
            *reinterpret_cast<float4*>(dvrow + 16 * j) =
                make_float4(dv[4 * j], dv[4 * j + 1], dv[4 * j + 2], dv[4 * j + 3]);
        }
    }
}

template <int D, int NT>
size_t smem_f32() {
    constexpr int NPAD = 16 * NT;
    return sizeof(float) * (4 * (size_t)NPAD * (D + 4) + 2 * (size_t)NPAD * (NPAD + 4))
           + NPAD * NPAD;
}

// --------------------------------------------------------------------- bf16

template <int D, int NT>
__global__ void __launch_bounds__(32 * NT) small_bwd_bf16(const Params p) {
    constexpr int NPAD = 16 * NT;
    constexpr int THREADS = 32 * NT;     // one warp per 16 rows
    constexpr int LD = D + 8;            // bf16 row stride of the q/k/v/dO tiles
    constexpr int LDP = NPAD + 8;        // bf16 row stride of the transposed p and ds tiles
    constexpr int KSTEPS = D / 16;       // mma k-steps over the head dim
    constexpr int NB_S = NPAD / 8;       // 8-key column blocks of a score tile
    constexpr int NB_O = D / 8;          // 8-column blocks of a gradient

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // NPAD x LD
    bf16* ks = qs + NPAD * LD;
    bf16* vs = ks + NPAD * LD;
    bf16* dos = vs + NPAD * LD;
    bf16* pT = dos + NPAD * LD;                     // NPAD x LDP, [key][query]
    bf16* dsT = pT + NPAD * LDP;
    uint8_t* ms = reinterpret_cast<uint8_t*>(dsT + NPAD * LDP);

    const int b = blockIdx.x / p.h;
    const int hh = blockIdx.x % p.h;
    const size_t stride = (size_t)p.h * D;
    const size_t base = head_base<D>(b, hh, p);
    load_head_bf16<D, LD, THREADS>(qs, static_cast<const bf16*>(p.q) + base, stride, NPAD, p.n);
    load_head_bf16<D, LD, THREADS>(ks, static_cast<const bf16*>(p.k) + base, stride, NPAD, p.n);
    load_head_bf16<D, LD, THREADS>(vs, static_cast<const bf16*>(p.v) + base, stride, NPAD, p.n);
    load_head_bf16<D, LD, THREADS>(dos, static_cast<const bf16*>(p.dout) + base, stride, NPAD, p.n);
    stage_mask<NPAD, THREADS>(ms, p);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;                       // fragment row group
    const int t = lane & 3;                        // fragment column pair
    const int w_row = (threadIdx.x >> 5) * 16;     // the warp's first row
    const int qi[2] = {w_row + g, w_row + g + 8};

    // s[nb][2r + e], dp[nb][2r + e]: query qi[r], key 8nb + 2t + e
    float s[NB_S][4], dp[NB_S][4], dsc[NB_S][4];
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
        uint32_t qf[4], gf[4];
        fa::load_a_frag<LD>(qf, qs, w_row, st * 16, g, t);
        fa::load_a_frag<LD>(gf, dos, w_row, st * 16, g, t);
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
            uint32_t kf[2], vf[2];
            fa::load_b_frag<LD>(kf, ks, nb * 8, st * 16, g, t);
            fa::load_b_frag<LD>(vf, vs, nb * 8, st * 16, g, t);
            fa::mma_16816(s[nb], qf, kf);
            fa::mma_16816(dp[nb], gf, vf);
        }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[nb][e] = small_score<NPAD>(s[nb][e], qi[e >> 1], nb * 8 + 2 * t + (e & 1), ms, p,
                                         dsc[nb][e]);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
        }
    }
    float sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[nb][e] = __expf(s[nb][e] - mx[e >> 1]);
            sum[e >> 1] += s[nb][e];
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            s[nb][e] = qi[r] < p.n ? s[nb][e] / sum[r] : 0.f;
            dot[r] += dp[nb][e] * s[nb][e];
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
    }
    // ds into dp; p and ds, rounded to bf16, into the transposed tiles
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            dp[nb][e] = s[nb][e] * (dp[nb][e] - dot[r]) * dsc[nb][e] * p.clamp.scale;
            const int kj = nb * 8 + 2 * t + (e & 1);
            pT[kj * LDP + qi[r]] = __float2bfloat16(s[nb][e]);
            dsT[kj * LDP + qi[r]] = __float2bfloat16(dp[nb][e]);
        }
    }

    // dQ = round(dS) . K for the warp's query rows
    float acc[NB_O][4];
#pragma unroll
    for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NPAD / 16; ++kk) {
        uint32_t dsf[4];
        fa::acc_to_a_frag(dsf, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            uint32_t kf[2];
            fa::ldmatrix_x2_trans(kf, ks + (kk * 16 + (lane & 15)) * LD + nb * 8);
            fa::mma_16816(acc[nb], dsf, kf);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (qi[r] >= p.n) continue;
        bf16* row = static_cast<bf16*>(p.o) + base + qi[r] * stride;
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            *reinterpret_cast<uint32_t*>(row + nb * 8 + 2 * t) =
                fa::pack_bf16x2(acc[nb][2 * r], acc[nb][2 * r + 1]);
        }
    }
    __syncthreads();   // every warp's rows of pT and dsT are written

    // dK = dS^T . Q and dV = P^T . dO for the warp's 16 key rows
    float dk[NB_O][4], dv[NB_O][4];
#pragma unroll
    for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NPAD / 16; ++kk) {
        uint32_t dsf[4], pf[4];
        fa::load_a_frag<LDP>(dsf, dsT, w_row, kk * 16, g, t);
        fa::load_a_frag<LDP>(pf, pT, w_row, kk * 16, g, t);
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            uint32_t qf[2], gf[2];
            fa::ldmatrix_x2_trans(qf, qs + (kk * 16 + (lane & 15)) * LD + nb * 8);
            fa::ldmatrix_x2_trans(gf, dos + (kk * 16 + (lane & 15)) * LD + nb * 8);
            fa::mma_16816(dk[nb], dsf, qf);
            fa::mma_16816(dv[nb], pf, gf);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int kj = qi[r];   // this lane's key rows: the same row numbers
        if (kj >= p.n) continue;
        bf16* dkrow = static_cast<bf16*>(p.dk) + base + kj * stride;
        bf16* dvrow = static_cast<bf16*>(p.dv) + base + kj * stride;
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            *reinterpret_cast<uint32_t*>(dkrow + nb * 8 + 2 * t) =
                fa::pack_bf16x2(dk[nb][2 * r], dk[nb][2 * r + 1]);
            *reinterpret_cast<uint32_t*>(dvrow + nb * 8 + 2 * t) =
                fa::pack_bf16x2(dv[nb][2 * r], dv[nb][2 * r + 1]);
        }
    }
}

template <int D, int NT>
size_t smem_bf16() {
    constexpr int NPAD = 16 * NT;
    return sizeof(bf16) * (4 * (size_t)NPAD * (D + 8) + 2 * (size_t)NPAD * (NPAD + 8))
           + NPAD * NPAD;
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, int blocks, int threads, const Params& p,
                          cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int D, int NT>
cudaError_t launch(const Params& p, int blocks, int dtype, cudaStream_t stream) {
    if (dtype == 0) return launch_kernel(small_bwd_f32<D, NT>, smem_f32<D, NT>(), blocks, 64 * NT, p, stream);
    if (dtype == 1) return launch_kernel(small_bwd_bf16<D, NT>, smem_bf16<D, NT>(), blocks, 32 * NT, p, stream);
    return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_d(const Params& p, int blocks, int dtype, cudaStream_t stream) {
    if (p.n <= 16) return launch<D, 1>(p, blocks, dtype, stream);
    if (p.n <= 32) return launch<D, 2>(p, blocks, dtype, stream);
    return launch<D, 4>(p, blocks, dtype, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16.
// mask may be null (no mask); softclamp <= 0 means no softclamp. Writes dq,
// dk and dv. Returns the CUDA error code of the launch (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int small_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const uint8_t* mask, void* dq, void* dk, void* dv, int B, int n,
                              int h, int D, int dtype, float scale, float softclamp,
                              void* stream) {
    if (B <= 0 || n <= 0 || n > 64 || h <= 0) return (int)cudaErrorInvalidValue;
    if ((long long)B * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;   // grid x limit
    Params p = make_params(n, h, scale, softclamp);
    p.q = q;
    p.k = k;
    p.v = v;
    p.dout = dout;
    p.mask = mask;
    p.o = dq;
    p.dk = dk;
    p.dv = dv;
    const int blocks = B * h;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return (int)launch_d<16>(p, blocks, dtype, s);
        case 32: return (int)launch_d<32>(p, blocks, dtype, s);
        case 64: return (int)launch_d<64>(p, blocks, dtype, s);
        case 128: return (int)launch_d<128>(p, blocks, dtype, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
