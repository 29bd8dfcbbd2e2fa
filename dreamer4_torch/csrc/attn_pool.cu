// Attention-pool kernels for Hopper (sm_90a): the trunk's pools
// (dreamer4_torch/nn/attention.py `_StreamingPoolAttention`) and the
// normalization of the hiddens they read (`rms_normalize`).
//
// Replaces no Pallas kernel: the JAX package leaves the pools to XLA, which
// fuses their elementwise chains. The port's plain version runs each pool as
// some 56 launches forward and 170 forward and backward (the head norm of the
// (L, N, h, dh) keys, two batched matrix-vector products, softclamp, softmax,
// casts) and each hidden's normalization as 7-9, about 1,500 launches and a
// dozen passes over the keys per trunk pass of a depth-8 trunk.
//
// Pool, per token n and head (q, k, v in the stream dtype; q (N, h dh), the
// keys and values (L, N, h dh) as the projections write them; the head-norm
// scale (h, dh) in float32; the gate logits (N, h)):
//   k^_l = k_l * rsqrt(sum k_l^2 + 1e-12) * scale
//   s_l  = c * tanh(q . k^_l / (sqrt(dh) c))         (c the softclamp; none: q . k^_l / sqrt(dh))
//   out  = sigmoid(gate) * sum_l softmax_l(s) v_l     (N, h dh), stream dtype
// One warp takes one token: lane j holds elements 8j .. 8j + 7 of the token's
// 4 x 64 (8 lanes a head, reduced by xor shuffles), 16 bytes a row in bf16. The forward reads k and v once, keeps the softmax online in
// float32 and writes the output; before a backward also the row's
// log-sum-exp (N, h) and the un-gated output o (N, h dh) in float32. The
// backward is one pass over the layers per token: o gives the gate's gradient
// and the softmax's delta up front, so each layer's dk (through the head
// norm) and dv are written as its k and v are read, with no second read of
// the keys; the scale's gradient is summed per block (no atomics) and a
// one-block pass sums the blocks' partials in a fixed order. The gate's
// sigmoid is folded into both kernels: they take the logits and return the
// logits' gradient.
//
// Bound: bytes. At the last pool of a b8 x T192 world-model step (L = 17,
// N = 41,472, 4 x 64, bf16) the forward moves 765 MB (0.228 ms at 3.35 TB/s),
// the backward 1.51 GB (0.450 ms), each input read once and each output
// written once; o adds 42 MB to each. Every element moves as whole 16-byte
// vectors, and 256-thread blocks keep enough rows in flight to cover the
// memory's latency.
//
// rms_normalize: x * rsqrt(mean(x^2) + eps) per row, the statistic in float32,
// one warp a row; its backward dx = r dy - r^3 x (x . dy) / d from x and dy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 8;              // elements a lane holds of a row
constexpr int ROW = 32 * VEC;       // h * dh of the pool: a warp covers a token
constexpr int HEADS = 4;            // the pool's heads, of DIM_HEAD each
constexpr int DIM_HEAD = ROW / HEADS;
constexpr int LPH = DIM_HEAD / VEC; // lanes a head
static_assert(THREADS == ROW, "the scale's partial sums take one thread per element");

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
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Sum over the LPH lanes of a head (an aligned group of lanes). Float addition
// commutes, so every lane of the group ends with the same bits.
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
    for (int off = LPH / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// ---------------------------------------------------------------- pool

// One score: the head norm's reciprocal r of k and s = softclamp(r (q scale) . k
// / sqrt(dh)); `t` is tanh's value (0 without a softclamp).
__device__ __forceinline__ void score(const float (&qs)[VEC], const float (&kf)[VEC],
                                      float sm_scale, float softclamp, float& r, float& s,
                                      float& t) {
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
        ss = fmaf(kf[i], kf[i], ss);
        dot = fmaf(qs[i], kf[i], dot);
    }
    ss = head_sum(ss);
    dot = head_sum(dot);
    r = rsqrtf(ss + 1e-12f);
    s = dot * r * sm_scale;
    t = 0.f;
    if (softclamp > 0.f) {
        t = tanhf(s / softclamp);
        s = softclamp * t;
    }
}

// lse and o are null when no backward follows; else the row's log-sum-exp
// (N, h) and the un-gated output (N, h dh) in float32 for the backward.
template <typename T>
__global__ void __launch_bounds__(THREADS) attn_pool_fwd(
        const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        const float* __restrict__ scale, const T* __restrict__ gate, T* __restrict__ out,
        float* __restrict__ lse, float* __restrict__ o, int n, int layers, float sm_scale,
        float softclamp) {
    const int lane = threadIdx.x & 31;
    const int tok = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (tok >= n) return;
    const int head = lane / LPH;
    const int64_t row = (int64_t)tok * ROW + lane * VEC;
    const int64_t plane = (int64_t)n * ROW;

    float qs[VEC];
    load8(q + row, qs);
#pragma unroll
    for (int i = 0; i < VEC; ++i) qs[i] *= scale[lane * VEC + i];

    float m = -INFINITY, den = 0.f, acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 2
    for (int l = 0; l < layers; ++l) {
        float kf[VEC], vf[VEC];
        load8(k + l * plane + row, kf);
        load8(v + l * plane + row, vf);
        float r, s, t;
        score(qs, kf, sm_scale, softclamp, r, s, t);
        const float m_new = fmaxf(m, s);
        const float corr = expf(m - m_new);
        const float p = expf(s - m_new);
        den = fmaf(den, corr, p);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vf[i], acc[i] * corr);
        m = m_new;
    }
    const float inv_den = 1.f / den;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= inv_den;
    if (o != nullptr) {
        store8(o + row, acc);
        if ((lane & (LPH - 1)) == 0) lse[tok * HEADS + head] = m + logf(den);
    }
    const float g = sigmoid(to_float(gate[tok * HEADS + head]));
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= g;
    store8(out + row, acc);
}

// One pass over the layers per token. From the forward's o: dg = dout . o and
// delta = sum_l p_l dp_l = g dout . o. Then per layer: p_l = exp(s_l - lse),
// dp_l = do . v_l (do = g dout), dv_l = p_l do, dz_l = p_l (dp_l - delta)
// (1 - t_l^2) / sqrt(dh); with w = q scale and u_l = r_l k_l: dq += dz_l u_l
// scale, the scale's gradient += dz_l q u_l, dk_l = dz_l r_l (w - u_l (u_l .
// w)), where u_l . w = r_l (w . k_l) is the score's own dot product. Each
// warp walks tokens tok, tok + gridDim.x * WARPS, ...; the grid is fixed by
// N, so the partial sums, and the scale's gradient, repeat bitwise.
template <typename T>
__global__ void __launch_bounds__(THREADS) attn_pool_bwd(
        const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
        const float* __restrict__ scale, const T* __restrict__ gate,
        const float* __restrict__ lse, const float* __restrict__ o, const T* __restrict__ dout,
        T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dgate,
        float* __restrict__ partials, int n, int layers, float sm_scale, float softclamp) {
    __shared__ float red[WARPS][ROW];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int head = lane / LPH;
    const int64_t plane = (int64_t)n * ROW;

    float sc[VEC], dsc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
        sc[i] = scale[lane * VEC + i];
        dsc[i] = 0.f;
    }
    for (int tok = blockIdx.x * WARPS + warp; tok < n; tok += gridDim.x * WARPS) {
        const int64_t row = (int64_t)tok * ROW + lane * VEC;
        const int hrow = tok * HEADS + head;
        float qf[VEC], qs[VEC], dov[VEC], dqa[VEC], go[VEC];
        load8(q + row, qf);
        load8(dout + row, go);
        float dg = 0.f;
        {
            float of[VEC];
            load8(o + row, of);
#pragma unroll
            for (int i = 0; i < VEC; ++i) dg = fmaf(go[i], of[i], dg);
        }
        dg = head_sum(dg);
        const float g = sigmoid(to_float(gate[hrow]));
        if ((lane & (LPH - 1)) == 0) dgate[hrow] = from_float<T>(dg * g * (1.f - g));
        const float delta = g * dg;
        const float row_lse = lse[hrow];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            qs[i] = qf[i] * sc[i];
            dov[i] = g * go[i];
            dqa[i] = 0.f;
        }
#pragma unroll 2
        for (int l = 0; l < layers; ++l) {
            float kf[VEC], vf[VEC];
            load8(k + l * plane + row, kf);
            load8(v + l * plane + row, vf);
            float ss = 0.f, dot = 0.f, dp = 0.f;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                ss = fmaf(kf[i], kf[i], ss);
                dot = fmaf(qs[i], kf[i], dot);
                dp = fmaf(dov[i], vf[i], dp);
            }
            ss = head_sum(ss);
            dot = head_sum(dot);
            dp = head_sum(dp);
            const float r = rsqrtf(ss + 1e-12f);
            float s = dot * r * sm_scale, dsdz = 1.f;
            if (softclamp > 0.f) {
                const float t = tanhf(s / softclamp);
                s = softclamp * t;
                dsdz = 1.f - t * t;
            }
            const float p = expf(s - row_lse);
            const float dz = p * (dp - delta) * dsdz * sm_scale;
            const float uw = r * dot;            // u . w
            const float dzr = dz * r;
            float dkl[VEC], dvl[VEC];
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                const float u = kf[i] * r;
                dqa[i] = fmaf(dz * u, sc[i], dqa[i]);
                dsc[i] = fmaf(dz * qf[i], u, dsc[i]);
                dkl[i] = dzr * (qs[i] - u * uw);
                dvl[i] = p * dov[i];
            }
            store8(dk + l * plane + row, dkl);
            store8(dv + l * plane + row, dvl);
        }
        store8(dq + row, dqa);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[warp][lane * VEC + i] = dsc[i];
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][threadIdx.x];
    partials[(int64_t)blockIdx.x * ROW + threadIdx.x] = sum;
}

// The scale's gradient: the blocks' partial sums, in block order.
__global__ void __launch_bounds__(ROW) attn_pool_dscale(const float* __restrict__ partials,
                                                        int blocks, float* __restrict__ dscale) {
    float sum = 0.f;
    for (int b = 0; b < blocks; ++b) sum += partials[(int64_t)b * ROW + threadIdx.x];
    dscale[threadIdx.x] = sum;
}

// ---------------------------------------------------------------- rms_normalize

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) attn_pool_rms_fwd(const T* __restrict__ x,
                                                             T* __restrict__ y, int rows,
                                                             int dim, float eps) {
    const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (r >= rows) return;
    const int lane = threadIdx.x & 31;
    const T* __restrict__ xr = x + (int64_t)r * dim;
    T* __restrict__ yr = y + (int64_t)r * dim;
    float ss = 0.f;
    for (int c = lane * VEC; c < dim; c += ROW) {
        float a[VEC];
        load8(xr + c, a);
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss = fmaf(a[i], a[i], ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)dim + eps);
    for (int c = lane * VEC; c < dim; c += ROW) {
        float a[VEC];
        load8(xr + c, a);
#pragma unroll
        for (int i = 0; i < VEC; ++i) a[i] *= inv;
        store8(yr + c, a);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) attn_pool_rms_bwd(const T* __restrict__ x,
                                                             const T* __restrict__ dy,
                                                             T* __restrict__ dx, int rows,
                                                             int dim, float eps) {
    const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (r >= rows) return;
    const int lane = threadIdx.x & 31;
    const int64_t base = (int64_t)r * dim;
    float ss = 0.f, xd = 0.f;
    for (int c = lane * VEC; c < dim; c += ROW) {
        float a[VEC], b[VEC];
        load8(x + base + c, a);
        load8(dy + base + c, b);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
            ss = fmaf(a[i], a[i], ss);
            xd = fmaf(a[i], b[i], xd);
        }
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)dim + eps);
    const float coef = inv * inv * inv * warp_sum(xd) / (float)dim;
    for (int c = lane * VEC; c < dim; c += ROW) {
        float a[VEC], b[VEC];
        load8(x + base + c, a);
        load8(dy + base + c, b);
#pragma unroll
        for (int i = 0; i < VEC; ++i) a[i] = inv * b[i] - coef * a[i];
        store8(dx + base + c, a);
    }
}

int blocks_of(int rows) { return (rows + WARPS - 1) / WARPS; }

int last_error() { return (int)cudaGetLastError(); }

template <typename T>
int pool_forward(const void* q, const void* k, const void* v, const float* scale,
                 const void* gate, void* out, float* lse, float* o, int n, int layers,
                 float sm_scale, float softclamp, cudaStream_t stream) {
    attn_pool_fwd<T><<<blocks_of(n), THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), scale,
        static_cast<const T*>(gate), static_cast<T*>(out), lse, o, n, layers, sm_scale,
        softclamp);
    return last_error();
}

template <typename T>
int pool_backward(const void* q, const void* k, const void* v, const float* scale,
                  const void* gate, const float* lse, const float* o, const void* dout,
                  void* dq, void* dk, void* dv, void* dgate, float* partials, float* dscale,
                  int n, int layers, float sm_scale, float softclamp, int blocks,
                  cudaStream_t stream) {
    attn_pool_bwd<T><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), scale,
        static_cast<const T*>(gate), lse, o, static_cast<const T*>(dout), static_cast<T*>(dq),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dgate), partials, n, layers,
        sm_scale, softclamp);
    const int err = last_error();
    if (err != 0) return err;
    attn_pool_dscale<<<1, ROW, 0, stream>>>(partials, blocks, dscale);
    return last_error();
}

}  // namespace

// Host entry points: pointers to contiguous tensors on the current device,
// `dtype` 0 for float32 and 1 for bf16, the pool's 4 heads of 64. Each
// launches on `stream` without synchronizing and returns 0 or the CUDA error
// of a launch; -1 for a dtype it does not take. `softclamp` 0 means none.

// lse (N, h) and o (N, h dh), float32, both null when no backward follows
extern "C" int attn_pool_forward(const void* q, const void* k, const void* v,
                                 const float* scale, const void* gate, void* out, float* lse,
                                 float* o, int n, int layers, int dtype, float sm_scale,
                                 float softclamp, cudaStream_t stream) {
    if (dtype == 1)
        return pool_forward<__nv_bfloat16>(q, k, v, scale, gate, out, lse, o, n, layers,
                                           sm_scale, softclamp, stream);
    if (dtype == 0)
        return pool_forward<float>(q, k, v, scale, gate, out, lse, o, n, layers, sm_scale,
                                   softclamp, stream);
    return -1;
}

// partials: blocks * 256 floats of scratch; dscale: 256 floats (h, dh)
extern "C" int attn_pool_backward(const void* q, const void* k, const void* v,
                                  const float* scale, const void* gate, const float* lse,
                                  const float* o, const void* dout, void* dq, void* dk,
                                  void* dv, void* dgate, float* partials, float* dscale, int n,
                                  int layers, int dtype, float sm_scale, float softclamp,
                                  int blocks, cudaStream_t stream) {
    if (dtype == 1)
        return pool_backward<__nv_bfloat16>(q, k, v, scale, gate, lse, o, dout, dq, dk, dv,
                                            dgate, partials, dscale, n, layers, sm_scale,
                                            softclamp, blocks, stream);
    if (dtype == 0)
        return pool_backward<float>(q, k, v, scale, gate, lse, o, dout, dq, dk, dv, dgate,
                                    partials, dscale, n, layers, sm_scale, softclamp, blocks,
                                    stream);
    return -1;
}

// dim a multiple of 8
extern "C" int attn_pool_rms_forward(const void* x, void* y, int rows, int dim, int dtype,
                                     float eps, cudaStream_t stream) {
    if (dtype == 1) {
        attn_pool_rms_fwd<__nv_bfloat16><<<blocks_of(rows), THREADS, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), rows, dim, eps);
    } else if (dtype == 0) {
        attn_pool_rms_fwd<float><<<blocks_of(rows), THREADS, 0, stream>>>(
            static_cast<const float*>(x), static_cast<float*>(y), rows, dim, eps);
    } else {
        return -1;
    }
    return last_error();
}

extern "C" int attn_pool_rms_backward(const void* x, const void* dy, void* dx, int rows, int dim,
                                      int dtype, float eps, cudaStream_t stream) {
    if (dtype == 1) {
        attn_pool_rms_bwd<__nv_bfloat16><<<blocks_of(rows), THREADS, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
            static_cast<__nv_bfloat16*>(dx), rows, dim, eps);
    } else if (dtype == 0) {
        attn_pool_rms_bwd<float><<<blocks_of(rows), THREADS, 0, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dx),
            rows, dim, eps);
    } else {
        return -1;
    }
    return last_error();
}
