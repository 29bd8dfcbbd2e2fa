// Shared pieces of the port's flash-attention kernels (K1 forward, K2 dq,
// K3 dk/dv): the mask predicate family of the TPU kernels' `_mask_block`,
// the softclamp as K1 computes it, and the bf16 tensor-core fragments.
//
// Every kernel evaluates the softclamp and the mask through these functions,
// so the backward recomputes exactly the scores whose log-sum-exp K1 saved.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fa {

constexpr float NEG_INF = -1e30f;

struct MaskParams {
    int N, M;                      // query rows, key rows
    int offset, kv_len;            // query i sits at i + offset; keys >= kv_len are invalid
    float scale;
    float softclamp;               // <= 0: none
    float tanh_k;                  // 2 log2(e) scale / softclamp
    int causal, num_special, special_seq_len, special_only_itself;
};

inline MaskParams make_mask_params(int N, int M, int offset, int kv_len, float scale,
                                   float softclamp, int causal, int num_special,
                                   int special_seq_len, int special_only_itself) {
    MaskParams m;
    m.N = N;
    m.M = M;
    m.offset = offset;
    m.kv_len = kv_len;
    m.scale = scale;
    m.softclamp = softclamp;
    m.tanh_k = softclamp > 0.f ? 2.f * 1.4426950408889634f * scale / softclamp : 0.f;
    m.causal = causal;
    m.num_special = num_special;
    m.special_seq_len = special_seq_len;
    m.special_only_itself = special_only_itself;
    return m;
}

__device__ __forceinline__ int pos_mod(int x, int m) {
    const int r = x % m;
    return r < 0 ? r + m : r;
}

// special tokens sit at the right of every special_seq_len block; a query's
// position is taken as (i + offset)
__device__ __forceinline__ bool is_special(int pos, const MaskParams& p) {
    return pos_mod(pos, p.special_seq_len) >= p.special_seq_len - p.num_special;
}

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The scaled, softclamped score of a raw dot product, and in `dscore` its
// derivative with respect to the scaled score (1 - tanh^2, or 1 without a
// softclamp). The softclamp c * tanh(x / c) is taken as
// c * (1 - 2 / (e^(2x/c) + 1)) with one fast exponential, 2^(tanh_k * dot)
// (tanh_k folds the scale, 2 / c and log2 e). Its absolute error in tanh
// stays below about 1e-6, so a score moves by at most about c * 1e-6
// (5e-5 at c = 50); tanhf cost more than the matmuls of K1.
__device__ __forceinline__ float clamp_score(float dot, const MaskParams& p, float& dscore) {
    if (p.softclamp > 0.f) {
        // |2x/c| <= 30 keeps e finite; tanh(15) rounds to 1 in float32
        const float e = exp2_approx(fminf(fmaxf(dot * p.tanh_k, -43.f), 43.f));
        const float t = 1.f - __fdividef(2.f, e + 1.f);
        dscore = 1.f - t * t;
        return p.softclamp * t;
    }
    dscore = 1.f;
    return dot * p.scale;
}

// Whether query qi may attend to key kj, given both special flags.
__device__ __forceinline__ bool visible_given(int qi, bool q_special, int kj, bool k_special,
                                              const MaskParams& p) {
    bool ok = qi < p.N && kj < p.kv_len && kj < p.M;
    if (p.causal) ok = ok && kj <= qi + p.offset;
    if (p.num_special > 0) {
        ok = ok && (p.special_only_itself ? !(q_special && !k_special)
                                          : !(!q_special && k_special));
    }
    return ok;
}

// Whether query qi (q_special: its special flag) may attend to key kj.
__device__ __forceinline__ bool visible(int qi, bool q_special, int kj, const MaskParams& p) {
    return visible_given(qi, q_special, kj, p.num_special > 0 && is_special(kj, p), p);
}

// scale, softclamp, then the mask (the TPU kernel's order)
__device__ __forceinline__ float masked_score(float dot, int qi, bool q_special, int kj,
                                              const MaskParams& p) {
    float unused;
    const float x = clamp_score(dot, p, unused);
    return visible(qi, q_special, kj, p) ? x : NEG_INF;
}

// One past the last key any query of the q_rows-row tile starting at
// q_start may see. Keys from here on are masked for the whole tile: they are
// never read, and their rows of a staged tile are zeros, so a non-finite
// value left in an unused cache row cannot reach the output.
__device__ __forceinline__ int kv_end(int q_start, int q_rows, const MaskParams& p) {
    int k_end = min(p.kv_len, p.M);
    if (p.causal) k_end = min(k_end, min(q_start + q_rows, p.N) + p.offset);
    return max(k_end, 0);
}

// The first query of the first q_rows-row tile whose queries may see the
// key tile starting at k_start (the dk/dv walk starts there).
__device__ __forceinline__ int q_begin(int k_start, int q_rows, const MaskParams& p) {
    if (!p.causal) return 0;
    return max(k_start - p.offset, 0) / q_rows * q_rows;
}

// Whether every pair of the q_rows x k_rows tile at (q_start, k_start) is
// visible, so that the tile may skip the predicate: no special tokens, every
// query and key in range, the tile wholly at or below the causal diagonal.
__device__ __forceinline__ bool tile_all_visible(int q_start, int q_rows, int k_start, int k_rows,
                                                 const MaskParams& p) {
    return p.num_special == 0 && q_start + q_rows <= p.N &&
           k_start + k_rows <= min(p.kv_len, p.M) &&
           (!p.causal || k_start + k_rows - 1 <= q_start + p.offset);
}

constexpr float LOG2E = 1.4426950408889634f;

// The backward's p of one pair from its raw dot product s = q . k, with
// the softclamp exactly as `clamp_score` takes it and log2(e) folded into
// the LSE: lse2 = lse * log2(e), so p = 2^(log2(e) * score - lse2) costs one
// FMA and one fast exponential (the softclamp adds one exponential and one
// reciprocal). Returns p and, in `dscore`, the softclamp's derivative
// 1 - tanh^2 (1 without one): ds = p * dscore * (dp - delta) is the
// gradient of the scaled score. The mask is the caller's.
template <bool CLAMP>
__device__ __forceinline__ float backward_p(float dot, float lse2, const MaskParams& m,
                                            float& dscore) {
    if (CLAMP) {
        const float e = exp2_approx(fminf(fmaxf(dot * m.tanh_k, -43.f), 43.f));
        const float t = 1.f - __fdividef(2.f, e + 1.f);
        dscore = 1.f - t * t;
        return exp2_approx(fmaf(t, m.softclamp * LOG2E, -lse2));
    }
    dscore = 1.f;
    return exp2_approx(fmaf(dot, m.scale * LOG2E, -lse2));
}

// ------------------------------------------------------------------ float32

// `rows` rows of D floats (row stride D) into shared memory with row stride
// LD; rows >= valid_rows are zero-filled. 16-byte loads by THREADS threads.
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_f32_tile(float* __restrict__ dst, const float* __restrict__ src,
                                              int rows, int valid_rows) {
    constexpr int PER_ROW = D / 4;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW;
        const int c = (i % PER_ROW) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid_rows) val = *reinterpret_cast<const float4*>(src + (size_t)r * D + c);
        *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    }
}

// --------------------------------------------------------------------- bf16

using bf16 = __nv_bfloat16;

// `rows` rows of D bf16 (row stride D) into shared memory with row stride
// LD, as they are; rows >= valid_rows are zero-filled. 16-byte loads.
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_bf16_tile(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                               int rows, int valid_rows) {
    constexpr int PER_ROW = D / 8;
    for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
        const int r = i / PER_ROW;
        const int c = (i % PER_ROW) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < valid_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* ptr) {
    return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// acc + the dot product of 8 bf16 pairs (16 bytes each), in float32, in order
__device__ __forceinline__ float dot8_bf16(const uint4& a, const uint4& b, float acc) {
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(pa[i]);
        const float2 y = __bfloat1622float2(pb[i]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
    }
    return acc;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b for one 16x8x16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col), c float32
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the 16 rows starting at `row0` of a row-major [row][k] tile
// (row stride LD), k columns k0 .. k0 + 15. g, t: the lane's fragment row
// group and column pair.
template <int LD>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const bf16* tile, int row0, int k0,
                                            int g, int t) {
    const bf16* base = tile + (row0 + g) * LD + k0 + 2 * t;
    a[0] = ld_pair(base);
    a[1] = ld_pair(base + 8 * LD);
    a[2] = ld_pair(base + 8);
    a[3] = ld_pair(base + 8 * LD + 8);
}

// B fragment (k x 8, col) whose 8 columns are rows col0 .. col0 + 7 of a
// row-major [col][k] tile, k from k0: the operand of a product with the
// tile transposed (scores q . k^T).
template <int LD>
__device__ __forceinline__ void load_b_frag(uint32_t (&b)[2], const bf16* tile, int col0, int k0,
                                            int g, int t) {
    const bf16* row = tile + (col0 + g) * LD + k0 + 2 * t;
    b[0] = ld_pair(row);
    b[1] = ld_pair(row + 8);
}

// B fragment of a 16x8 slice of a row-major [k][n] tile: lanes 0-15 give
// the addresses of its 16 k rows; the transposing load hands each lane the
// (k, n) pairs the mma expects.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* ptr) {
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
}

// The score accumulators of 8-column blocks 2kk and 2kk + 1 (s[nb][2r + e]:
// row g + 8r, column 8nb + 2t + e) are exactly the A fragment of columns
// 16kk .. 16kk + 15, here rounded to bf16.
__device__ __forceinline__ void acc_to_a_frag(uint32_t (&a)[4], const float (&lo)[4],
                                              const float (&hi)[4]) {
    a[0] = pack_bf16x2(lo[0], lo[1]);
    a[1] = pack_bf16x2(lo[2], lo[3]);
    a[2] = pack_bf16x2(hi[0], hi[1]);
    a[3] = pack_bf16x2(hi[2], hi[3]);
}

}  // namespace fa
