// GLU feedforward kernels for Hopper (sm_90a): the elementwise parts of
// dreamer4_torch/nn/attention.py `FeedForward` (a GLU over silu or tanh gelu)
// around its two projections, which run as cuBLAS matrix products.
//
// Replaces no Pallas kernel: the JAX package leaves the feedforward to XLA,
// which fuses the GLU into its neighbours. The port's plain version hands the
// two strided halves of the (M, 2f) hidden to a `silu` and a `mul`, and their
// gradients and `chunk`'s copy back to PyTorch's generic kernel, while the
// inner width f = int(dim * 4 * 2/3) (1365 at dim 512) leaves the hidden's
// rows 2- or 4-byte aligned, so cuBLAS runs the projections on its pre-Hopper
// kernels.
//
// Layout. The hidden lives in rows padded to P = round_up(f, 8) elements, so
// every row of every operand of the six matrix products is a multiple of
// 16 bytes: h = x W_in_p^T + b_in_p is (M, 2P), its value half in columns
// [0, f) and its gate half in [P, P + f); a is (M, P); the pads of every
// operand hold exact zeros, so the products compute what the unpadded ones
// do.
//   glu_ff_pack:   the packed compute-dtype copies W_in_p (2P, d), b_in_p (2P),
//                  W_out_p (d, P) and b_out (d) of the parameters (float32 or
//                  bf16) in one launch, every pad written as zero
//   glu_ff_fwd:    a[:, j] = h[:, j] act(h[:, P + j]) for j < f, 0 for j >= f
//   glu_ff_bwd:    from dA = dy W_out_p and h, dh[:, j] = dA act(g) and
//                  dh[:, P + j] = dA x act'(g) for j < f, 0 in every pad
//   glu_ff_unpack: the parameters' gradients in their own shapes and dtype from
//                  dW_in_p, dW_out_p (compute dtype) and the float32 bias sums
// The activation is computed in float32 (act 0: silu, 1: tanh gelu) and each
// output is rounded once.
//
// Bound: bytes. At M = 41,472, d = 512 (a b8 x T192 world-model trunk call),
// f = 1365, P = 1368, bf16: the forward reads h (227 MB) and writes a (113 MB),
// 340 MB, 0.102 ms at 3.35 TB/s; the backward reads dA and h and writes dh,
// 567 MB, 0.169 ms. Each thread moves 8 consecutive elements of a row as
// 16-byte vectors (two in float32), neighbouring threads on neighbouring
// vectors; nothing is reduced, and one vector a thread over a grid that covers
// the rows keeps enough bytes in flight to cover the memory's latency. The
// pack and unpack move about 13 MB a call at d = 512 (a few microseconds) and
// replace the casts of the weights and of their gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;    // elements a thread moves of a row

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&x)[VEC]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float (&x)[VEC]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void store8(float* __restrict__ p, const float (&x)[VEC]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p, const float (&x)[VEC]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr float GELU_K0 = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float GELU_K1 = 0.044715f;

// act(g) and, with the gradient, act'(g)
template <int ACT>
__device__ __forceinline__ float act_fwd(float g) {
    if (ACT == 0) return g / (1.f + expf(-g));
    const float t = tanhf(GELU_K0 * (g + GELU_K1 * g * g * g));
    return 0.5f * g * (1.f + t);
}

template <int ACT>
__device__ __forceinline__ void act_fwd_bwd(float g, float& a, float& da) {
    if (ACT == 0) {
        const float s = 1.f / (1.f + expf(-g));
        a = g * s;
        da = s * (1.f + g * (1.f - s));
    } else {
        const float t = tanhf(GELU_K0 * (g + GELU_K1 * g * g * g));
        a = 0.5f * g * (1.f + t);
        da = 0.5f * (1.f + t) + 0.5f * g * (1.f - t * t) * GELU_K0 * (1.f + 3.f * GELU_K1 * g * g);
    }
}

// one thread a vector of 8 columns of a row: p8 vectors a row of a (P = 8 p8)
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS) glu_ff_fwd(const T* __restrict__ h, T* __restrict__ a,
                                                     uint32_t vectors, uint32_t p8, int f) {
    const uint32_t v = blockIdx.x * THREADS + threadIdx.x;
    if (v >= vectors) return;
    const uint32_t r = v / p8, c = v - r * p8;
    const size_t P = size_t(p8) * VEC;
    const T* hr = h + size_t(r) * 2 * P + size_t(c) * VEC;
    float x[VEC], g[VEC], o[VEC];
    load8(hr, x);
    load8(hr + P, g);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
        o[i] = int(c * VEC) + i < f ? x[i] * act_fwd<ACT>(g[i]) : 0.f;
    store8(a + size_t(r) * P + size_t(c) * VEC, o);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS) glu_ff_bwd(const T* __restrict__ da,
                                                     const T* __restrict__ h, T* __restrict__ dh,
                                                     uint32_t vectors, uint32_t p8, int f) {
    const uint32_t v = blockIdx.x * THREADS + threadIdx.x;
    if (v >= vectors) return;
    const uint32_t r = v / p8, c = v - r * p8;
    const size_t P = size_t(p8) * VEC;
    const size_t at = size_t(r) * 2 * P + size_t(c) * VEC;
    float d[VEC], x[VEC], g[VEC], dx[VEC], dg[VEC];
    load8(da + size_t(r) * P + size_t(c) * VEC, d);
    load8(h + at, x);
    load8(h + at + P, g);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
        if (int(c * VEC) + i < f) {
            float act, dact;
            act_fwd_bwd<ACT>(g[i], act, dact);
            dx[i] = d[i] * act;
            dg[i] = d[i] * x[i] * dact;
        } else {
            dx[i] = dg[i] = 0.f;
        }
    }
    store8(dh + at, dx);
    store8(dh + at + P, dg);
}

// the packed copies, one element a thread over the four outputs in turn:
// W_in_p (2P, d), b_in_p (2P), W_out_p (d, P), b_out (d)
template <typename S, typename T>
__global__ void __launch_bounds__(THREADS) glu_ff_pack(
    const S* __restrict__ w_in, const S* __restrict__ b_in, const S* __restrict__ w_out,
    const S* __restrict__ b_out, T* __restrict__ w_in_p, T* __restrict__ b_in_p,
    T* __restrict__ w_out_p, T* __restrict__ b_out_c, int d, int f, int P) {
    const uint32_t n0 = 2u * P * d, n1 = n0 + 2u * P, n2 = n1 + uint32_t(d) * P, n3 = n2 + d;
    for (uint32_t e = blockIdx.x * THREADS + threadIdx.x; e < n3; e += gridDim.x * THREADS) {
        if (e < n1) {
            // a row of the padded input projection, or its bias entry
            const bool bias = e >= n0;
            const uint32_t i = bias ? e - n0 : e / d;
            const uint32_t half = i >= uint32_t(P), j = i - half * P;
            float x = 0.f;
            if (j < uint32_t(f)) {
                const uint32_t src = half * f + j;
                x = bias ? to_float(b_in[src]) : to_float(w_in[src * d + (e - i * d)]);
            }
            if (bias) b_in_p[i] = from_float<T>(x);
            else w_in_p[e] = from_float<T>(x);
        } else if (e < n2) {
            const uint32_t k = e - n1, o = k / P, j = k - o * P;
            w_out_p[k] = from_float<T>(j < uint32_t(f) ? to_float(w_out[o * f + j]) : 0.f);
        } else {
            const uint32_t o = e - n2;
            b_out_c[o] = from_float<T>(to_float(b_out[o]));
        }
    }
}

// the parameters' gradients in their shapes: dW_in (2f, d), db_in (2f),
// dW_out (d, f), db_out (d), from the padded dW_in_p (2P, d) and dW_out_p
// (d, P) (compute dtype) and the float32 bias sums db_in_p (2P), db_out (d)
template <typename T, typename D>
__global__ void __launch_bounds__(THREADS) glu_ff_unpack(
    const T* __restrict__ dw_in_p, const float* __restrict__ db_in_p,
    const T* __restrict__ dw_out_p, const float* __restrict__ db_out_f, D* __restrict__ dw_in,
    D* __restrict__ db_in, D* __restrict__ dw_out, D* __restrict__ db_out, int d, int f, int P) {
    const uint32_t n0 = 2u * f * d, n1 = n0 + 2u * f, n2 = n1 + uint32_t(d) * f, n3 = n2 + d;
    // the padded row of a gradient row i of the input projection
    const auto row = [&](uint32_t i) { return i < uint32_t(f) ? i : P + i - f; };
    for (uint32_t e = blockIdx.x * THREADS + threadIdx.x; e < n3; e += gridDim.x * THREADS) {
        if (e < n0) {
            const uint32_t i = e / d;
            dw_in[e] = from_float<D>(to_float(dw_in_p[row(i) * d + (e - i * d)]));
        } else if (e < n1) {
            const uint32_t i = e - n0;
            db_in[i] = from_float<D>(db_in_p[row(i)]);
        } else if (e < n2) {
            const uint32_t k = e - n1, o = k / f, j = k - o * f;
            dw_out[k] = from_float<D>(to_float(dw_out_p[o * P + j]));
        } else {
            const uint32_t o = e - n2;
            db_out[o] = from_float<D>(db_out_f[o]);
        }
    }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

unsigned grid_of(long long n) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// the pack's and unpack's grid: a few waves of the card, each thread walking
unsigned walk_grid(long long n) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    return static_cast<unsigned>(blocks < 1 ? 1 : (blocks < 132 * 16 ? blocks : 132 * 16));
}

template <typename T>
int launch_fwd(const void* h, void* a, long long rows, int P, int f, int act, cudaStream_t stream) {
    const long long vectors = rows * (P / VEC);
    if (vectors >= (1LL << 31)) return -1;
    const auto hh = static_cast<const T*>(h);
    const auto aa = static_cast<T*>(a);
    if (act == 0)
        glu_ff_fwd<T, 0><<<grid_of(vectors), THREADS, 0, stream>>>(hh, aa, uint32_t(vectors),
                                                                   uint32_t(P / VEC), f);
    else
        glu_ff_fwd<T, 1><<<grid_of(vectors), THREADS, 0, stream>>>(hh, aa, uint32_t(vectors),
                                                                   uint32_t(P / VEC), f);
    return last_error();
}

template <typename T>
int launch_bwd(const void* da, const void* h, void* dh, long long rows, int P, int f, int act,
               cudaStream_t stream) {
    const long long vectors = rows * (P / VEC);
    if (vectors >= (1LL << 31)) return -1;
    const auto dd = static_cast<const T*>(da);
    const auto hh = static_cast<const T*>(h);
    const auto out = static_cast<T*>(dh);
    if (act == 0)
        glu_ff_bwd<T, 0><<<grid_of(vectors), THREADS, 0, stream>>>(dd, hh, out, uint32_t(vectors),
                                                                   uint32_t(P / VEC), f);
    else
        glu_ff_bwd<T, 1><<<grid_of(vectors), THREADS, 0, stream>>>(dd, hh, out, uint32_t(vectors),
                                                                   uint32_t(P / VEC), f);
    return last_error();
}

template <typename S, typename T>
int launch_pack(const void* w_in, const void* b_in, const void* w_out, const void* b_out,
                void* w_in_p, void* b_in_p, void* w_out_p, void* b_out_c, int d, int f, int P,
                cudaStream_t stream) {
    const long long n = 2LL * P * d + 2LL * P + (long long)d * P + d;
    if (n >= (1LL << 31)) return -1;
    glu_ff_pack<S, T><<<walk_grid(n), THREADS, 0, stream>>>(
        static_cast<const S*>(w_in), static_cast<const S*>(b_in), static_cast<const S*>(w_out),
        static_cast<const S*>(b_out), static_cast<T*>(w_in_p), static_cast<T*>(b_in_p),
        static_cast<T*>(w_out_p), static_cast<T*>(b_out_c), d, f, P);
    return last_error();
}

template <typename T, typename D>
int launch_unpack(const void* dw_in_p, const float* db_in_p, const void* dw_out_p,
                  const float* db_out_f, void* dw_in, void* db_in, void* dw_out, void* db_out,
                  int d, int f, int P, cudaStream_t stream) {
    const long long n = 2LL * f * d + 2LL * f + (long long)d * f + d;
    if (n >= (1LL << 31)) return -1;
    glu_ff_unpack<T, D><<<walk_grid(n), THREADS, 0, stream>>>(
        static_cast<const T*>(dw_in_p), db_in_p, static_cast<const T*>(dw_out_p), db_out_f,
        static_cast<D*>(dw_in), static_cast<D*>(db_in), static_cast<D*>(dw_out),
        static_cast<D*>(db_out), d, f, P);
    return last_error();
}

}  // namespace

// dtype codes: 0 float32, 1 bf16; act 0 silu, 1 tanh gelu. P a multiple of 8
// and at least f; every pointer 16-byte aligned. 0 on success, -1 for an
// unsupported argument, else the CUDA error.

extern "C" int glu_ff_forward(const void* h, void* a, long long rows, int P, int f, int dtype,
                              int act, cudaStream_t stream) {
    if (P % VEC != 0 || f > P || f < 1 || (act != 0 && act != 1)) return -1;
    if (dtype == 1) return launch_fwd<__nv_bfloat16>(h, a, rows, P, f, act, stream);
    if (dtype == 0) return launch_fwd<float>(h, a, rows, P, f, act, stream);
    return -1;
}

extern "C" int glu_ff_backward(const void* da, const void* h, void* dh, long long rows, int P,
                               int f, int dtype, int act, cudaStream_t stream) {
    if (P % VEC != 0 || f > P || f < 1 || (act != 0 && act != 1)) return -1;
    if (dtype == 1) return launch_bwd<__nv_bfloat16>(da, h, dh, rows, P, f, act, stream);
    if (dtype == 0) return launch_bwd<float>(da, h, dh, rows, P, f, act, stream);
    return -1;
}

// src: the parameters' dtype, dst: the compute dtype
extern "C" int glu_ff_pack_weights(const void* w_in, const void* b_in, const void* w_out,
                                   const void* b_out, void* w_in_p, void* b_in_p, void* w_out_p,
                                   void* b_out_c, int d, int f, int P, int src, int dst,
                                   cudaStream_t stream) {
    if (f > P || f < 1 || d < 1) return -1;
    using bf = __nv_bfloat16;
    if (src == 0 && dst == 0)
        return launch_pack<float, float>(w_in, b_in, w_out, b_out, w_in_p, b_in_p, w_out_p,
                                         b_out_c, d, f, P, stream);
    if (src == 0 && dst == 1)
        return launch_pack<float, bf>(w_in, b_in, w_out, b_out, w_in_p, b_in_p, w_out_p, b_out_c,
                                      d, f, P, stream);
    if (src == 1 && dst == 0)
        return launch_pack<bf, float>(w_in, b_in, w_out, b_out, w_in_p, b_in_p, w_out_p, b_out_c,
                                      d, f, P, stream);
    if (src == 1 && dst == 1)
        return launch_pack<bf, bf>(w_in, b_in, w_out, b_out, w_in_p, b_in_p, w_out_p, b_out_c, d,
                                   f, P, stream);
    return -1;
}

// src: the compute dtype of the weight gradients, dst: the parameters' dtype
extern "C" int glu_ff_unpack_grads(const void* dw_in_p, const float* db_in_p,
                                   const void* dw_out_p, const float* db_out_f, void* dw_in,
                                   void* db_in, void* dw_out, void* db_out, int d, int f, int P,
                                   int src, int dst, cudaStream_t stream) {
    if (f > P || f < 1 || d < 1) return -1;
    using bf = __nv_bfloat16;
    if (src == 0 && dst == 0)
        return launch_unpack<float, float>(dw_in_p, db_in_p, dw_out_p, db_out_f, dw_in, db_in,
                                           dw_out, db_out, d, f, P, stream);
    if (src == 1 && dst == 0)
        return launch_unpack<bf, float>(dw_in_p, db_in_p, dw_out_p, db_out_f, dw_in, db_in,
                                        dw_out, db_out, d, f, P, stream);
    if (src == 0 && dst == 1)
        return launch_unpack<float, bf>(dw_in_p, db_in_p, dw_out_p, db_out_f, dw_in, db_in,
                                        dw_out, db_out, d, f, P, stream);
    if (src == 1 && dst == 1)
        return launch_unpack<bf, bf>(dw_in_p, db_in_p, dw_out_p, db_out_f, dw_in, db_in, dw_out,
                                     db_out, d, f, P, stream);
    return -1;
}
