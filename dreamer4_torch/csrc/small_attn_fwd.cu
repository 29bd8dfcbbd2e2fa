// Small-attention forward for Hopper (sm_90a): K4 of the port.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (host `_fwd_host`) in
// dreamer4_tpu/ops/small_attention.py. It computes the same function, per
// (batch row, head):
//
//   s = (q . k) * scale                      float32
//   s = tanh(s / c) * c                       when a softclamp c is given
//   s = mask ? s : -1e30                      (n, n) mask, True = may attend
//   p = softmax(s)                            float32, normalized
//   o = round(p) . v                          p rounded to v's type, float32 sums,
//                                             o in v's type (the TPU kernel's points)
//
// Layout: q, k, v, o (B, n*h, D) contiguous, the projections' flat layout
// (row i*h + hh is token i of head hh); mask a (n, n) uint8 table or null.
// n <= 64; D is 16, 32, 64 or 128; float32 or bf16.
//
// Design. The TPU kernel computes all heads in one (n*h) x (n*h) product
// and discards the cross-head blocks with an interleaved bias: h-fold
// redundant score work that buys a wide MXU operand. On the card that buys
// nothing, so one block computes one (batch row, head) from the (n, n) mask
// alone. It reads its head's rows in place at a stride of h*D elements (no
// relayout copy before or after the kernel), pads n to NPAD = 16, 32 or 64
// rows in shared memory (the padding is zero-filled, never read from device
// memory, and its keys get score -inf, so p is exactly 0 there), and keeps
// the scores and probabilities in registers.
//   bf16: NPAD / 16 warps, 16 query rows each, on the tensor cores
//     (`mma.sync.m16n8k16`, float32 accumulation): S = Q K^T from fragments
//     of the staged tiles, the normalized probabilities rounded into the A
//     fragments of P V, V's B fragments through `ldmatrix.trans`.
//   float32: four threads per query row on the float32 cores.
// A query row that its mask lets see no key gets the mean of its own head's
// values here; the TPU kernel gives the mean over every head's values there
// (its whole row of the (n*h)^2 bias is -1e30). No mask of the trunk has
// such a row: causal and special-token masks always allow the diagonal.
//
// Bound. At the tokenizer's time layer (B = 640, n = 16, h = 8, D = 64,
// bf16, causal) the kernel must read q, k, v and write o: 4 x 10.5 MB,
// 12.5 us at 3.35 TB/s, against 0.37 GFLOP of per-head score and PV work
// (under 1 us at the bf16 tensor-core peak). So it is bound by bytes: each
// element is read once with 16-byte loads and nothing but o is written.

#include "small_attn_common.cuh"

namespace {

using namespace sa;
using fa::NEG_INF;

// ------------------------------------------------------------------ float32

template <int D, int NT>
__global__ void __launch_bounds__(64 * NT) small_fwd_f32(const Params p) {
    constexpr int NPAD = 16 * NT;
    constexpr int THREADS = 4 * NPAD;    // four threads per query row
    constexpr int LD = D + 4;            // padded row stride of the q/k/v tiles
    constexpr int LDP = NPAD + 4;        // row stride of the probability tile
    constexpr int COLS = NPAD / 4;       // keys per thread
    constexpr int DC = D / 4;            // output columns per thread

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qs = reinterpret_cast<float*>(smem_raw);   // NPAD x LD
    float* ks = qs + NPAD * LD;
    float* vs = ks + NPAD * LD;
    float* ps = vs + NPAD * LD;                        // NPAD x LDP
    uint8_t* ms = reinterpret_cast<uint8_t*>(ps + NPAD * LDP);

    const int b = blockIdx.x / p.h;
    const int hh = blockIdx.x % p.h;
    const size_t stride = (size_t)p.h * D;
    const size_t base = head_base<D>(b, hh, p);
    load_head_f32<D, LD, THREADS>(qs, static_cast<const float*>(p.q) + base, stride, NPAD, p.n);
    load_head_f32<D, LD, THREADS>(ks, static_cast<const float*>(p.k) + base, stride, NPAD, p.n);
    load_head_f32<D, LD, THREADS>(vs, static_cast<const float*>(p.v) + base, stride, NPAD, p.n);
    stage_mask<NPAD, THREADS>(ms, p);
    __syncthreads();

    const int row = threadIdx.x >> 2;
    const int quad = threadIdx.x & 3;

    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[j] = 0.f;
    const float* qrow = qs + row * LD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
            const float4 k4 = *reinterpret_cast<const float4*>(ks + (quad + 4 * j) * LD + d);
            s[j] = fmaf(q4.x, k4.x, s[j]);
            s[j] = fmaf(q4.y, k4.y, s[j]);
            s[j] = fmaf(q4.z, k4.z, s[j]);
            s[j] = fmaf(q4.w, k4.w, s[j]);
        }
    }

    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
        float unused;
        s[j] = small_score<NPAD>(s[j], row, quad + 4 * j, ms, p, unused);
        mx = fmaxf(mx, s[j]);
    }
    // the four threads of a row are adjacent lanes of one warp
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
    float* prow = ps + row * LDP;
#pragma unroll
    for (int j = 0; j < COLS; ++j) prow[quad + 4 * j] = s[j] / sum;
    __syncwarp();

    // acc[4j + c]: output column 4 * quad + 16 * j + c
    float acc[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[j] = 0.f;
    for (int c = 0; c < p.n; ++c) {
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
    if (row < p.n) {
        float* orow = static_cast<float*>(p.o) + base + row * stride + 4 * quad;
#pragma unroll
        for (int j = 0; j < DC / 4; ++j) {
            *reinterpret_cast<float4*>(orow + 16 * j) =
                make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
        }
    }
}

template <int D, int NT>
size_t smem_f32() {
    constexpr int NPAD = 16 * NT;
    return sizeof(float) * (3 * (size_t)NPAD * (D + 4) + (size_t)NPAD * (NPAD + 4)) + NPAD * NPAD;
}

// --------------------------------------------------------------------- bf16

template <int D, int NT>
__global__ void __launch_bounds__(32 * NT) small_fwd_bf16(const Params p) {
    constexpr int NPAD = 16 * NT;
    constexpr int THREADS = 32 * NT;     // one warp per 16 query rows
    constexpr int LD = D + 8;            // bf16 row stride of the tiles (16-byte pad)
    constexpr int KSTEPS = D / 16;       // mma k-steps over the head dim
    constexpr int NB_S = NPAD / 8;       // 8-key column blocks of the score tile
    constexpr int NB_O = D / 8;          // 8-column blocks of the output

    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // NPAD x LD
    bf16* ks = qs + NPAD * LD;
    bf16* vs = ks + NPAD * LD;
    uint8_t* ms = reinterpret_cast<uint8_t*>(vs + NPAD * LD);

    const int b = blockIdx.x / p.h;
    const int hh = blockIdx.x % p.h;
    const size_t stride = (size_t)p.h * D;
    const size_t base = head_base<D>(b, hh, p);
    load_head_bf16<D, LD, THREADS>(qs, static_cast<const bf16*>(p.q) + base, stride, NPAD, p.n);
    load_head_bf16<D, LD, THREADS>(ks, static_cast<const bf16*>(p.k) + base, stride, NPAD, p.n);
    load_head_bf16<D, LD, THREADS>(vs, static_cast<const bf16*>(p.v) + base, stride, NPAD, p.n);
    stage_mask<NPAD, THREADS>(ms, p);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;                       // fragment row group
    const int t = lane & 3;                        // fragment column pair
    const int w_row = (threadIdx.x >> 5) * 16;     // the warp's first query row
    const int qi[2] = {w_row + g, w_row + g + 8};

    // s[nb][2r + e]: query qi[r], key 8nb + 2t + e
    float s[NB_S][4];
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    }
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
        uint32_t qf[4];
        fa::load_a_frag<LD>(qf, qs, w_row, st * 16, g, t);
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
            uint32_t kf[2];
            fa::load_b_frag<LD>(kf, ks, nb * 8, st * 16, g, t);
            fa::mma_16816(s[nb], qf, kf);
        }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float unused;
            s[nb][e] = small_score<NPAD>(s[nb][e], qi[e >> 1], nb * 8 + 2 * t + (e & 1), ms, p,
                                         unused);
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
        }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        // the four lanes of a row group hold its scores
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
        for (int e = 0; e < 4; ++e) s[nb][e] = s[nb][e] / sum[e >> 1];
    }

    // O = round(P) . V: the accumulators of key blocks 2kk, 2kk + 1 are the
    // A fragment of keys 16kk .. 16kk + 15
    float acc[NB_O][4];
#pragma unroll
    for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NPAD / 16; ++kk) {
        uint32_t pf[4];
        fa::acc_to_a_frag(pf, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            uint32_t vf[2];
            fa::ldmatrix_x2_trans(vf, vs + (kk * 16 + (lane & 15)) * LD + nb * 8);
            fa::mma_16816(acc[nb], pf, vf);
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (qi[r] >= p.n) continue;
        bf16* orow = static_cast<bf16*>(p.o) + base + qi[r] * stride;
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
            *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * t) =
                fa::pack_bf16x2(acc[nb][2 * r], acc[nb][2 * r + 1]);
        }
    }
}

template <int D, int NT>
size_t smem_bf16() {
    constexpr int NPAD = 16 * NT;
    return sizeof(bf16) * 3 * (size_t)NPAD * (D + 8) + NPAD * NPAD;
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
    if (dtype == 0) return launch_kernel(small_fwd_f32<D, NT>, smem_f32<D, NT>(), blocks, 64 * NT, p, stream);
    if (dtype == 1) return launch_kernel(small_fwd_bf16<D, NT>, smem_bf16<D, NT>(), blocks, 32 * NT, p, stream);
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
// mask may be null (no mask); softclamp <= 0 means no softclamp. Returns the
// CUDA error code of the launch (0 on success); the launch is asynchronous
// on `stream`.
extern "C" int small_attn_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                              void* o, int B, int n, int h, int D, int dtype, float scale,
                              float softclamp, void* stream) {
    if (B <= 0 || n <= 0 || n > 64 || h <= 0) return (int)cudaErrorInvalidValue;
    if ((long long)B * h > 0x7fffffffLL) return (int)cudaErrorInvalidValue;   // grid x limit
    Params p = make_params(n, h, scale, softclamp);
    p.q = q;
    p.k = k;
    p.v = v;
    p.mask = mask;
    p.o = o;
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
