// Shared pieces of the port's small-attention kernels (K4 forward, K5
// backward): the flat layout's strided row loads, the mask table and the
// launch parameters. The softclamp and the bf16 tensor-core fragments are
// those of the flash kernels (flash_attn_common.cuh), so both families
// round and clamp alike.
//
// Layout: q, k, v, o (and dO, dq, dk, dv) are (B, n*h, D), contiguous; row
// i*h + hh holds token i of head hh, so one head's rows sit h*D elements
// apart. One block computes one (batch row, head) with n padded to NPAD =
// 16, 32 or 64 rows.

#pragma once

#include "flash_attn_common.cuh"

namespace sa {

using fa::bf16;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;              // K5 only
    const uint8_t* mask;           // (n, n), 1 = may attend; null: no mask
    void* o;                       // K4: o; K5: dq
    void* dk;                      // K5 only
    void* dv;                      // K5 only
    int n, h;
    fa::MaskParams clamp;          // scale and softclamp, as the flash kernels take them
};

// padded keys (kj >= n) get this score: exp of it is exactly 0, so they
// never enter a softmax, a sum or a gradient
__device__ __forceinline__ float pad_score() { return __int_as_float(0xff800000); }   // -inf

// offset of row 0 of head hh of batch row b, in elements
template <int D>
__device__ __forceinline__ size_t head_base(int b, int hh, const Params& p) {
    return ((size_t)b * p.n * p.h + hh) * D;
}

// NPAD rows of one head (row stride h*D) into shared memory with row stride
// LD; rows >= n are zero-filled and never read from device memory.
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_head_bf16(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                               size_t row_stride, int rows, int valid_rows) {
    constexpr int PER_ROW = D / 8;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW;
        const int c = (i % PER_ROW) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid_rows) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_head_f32(float* __restrict__ dst, const float* __restrict__ src,
                                              size_t row_stride, int rows, int valid_rows) {
    constexpr int PER_ROW = D / 4;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW;
        const int c = (i % PER_ROW) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid_rows) val = *reinterpret_cast<const float4*>(src + r * row_stride + c);
        *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    }
}

// The (n, n) mask as an NPAD x NPAD table in shared memory; entries outside
// n x n are 0 (padded keys are excluded by `pad_score` besides).
template <int NPAD, int THREADS>
__device__ __forceinline__ void stage_mask(uint8_t* __restrict__ dst, const Params& p) {
    for (int i = threadIdx.x; i < NPAD * NPAD; i += THREADS) {
        const int r = i / NPAD;
        const int c = i % NPAD;
        uint8_t allowed = 0;
        if (r < p.n && c < p.n) allowed = p.mask == nullptr ? 1 : (p.mask[r * p.n + c] != 0);
        dst[i] = allowed;
    }
}

// The score of query qi and key kj from the raw dot product: padded keys
// excluded, then scale and softclamp, then the mask (the TPU kernel's
// order). dscore: the softclamp's derivative 1 - tanh^2 (1 without one).
template <int NPAD>
__device__ __forceinline__ float small_score(float dot, int qi, int kj, const uint8_t* ms,
                                             const Params& p, float& dscore) {
    if (kj >= p.n) {
        dscore = 0.f;
        return pad_score();
    }
    const float x = fa::clamp_score(dot, p.clamp, dscore);
    return ms[qi * NPAD + kj] ? x : fa::NEG_INF;
}

inline Params make_params(int n, int h, float scale, float softclamp) {
    Params p{};
    p.n = n;
    p.h = h;
    p.clamp = fa::make_mask_params(n, n, 0, n, scale, softclamp, 0, 0, 0, 0);
    return p;
}

}  // namespace sa
