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
// nothing, so each head is computed on its own from the (n, n) mask alone,
// which each consumer thread keeps as bits of its query rows in registers
// for the whole launch. A persistent block walks items of one batch row and
// G heads (small_attn_common.cuh): one producer warp streams each item's q,
// k and v rows into a ring of shared-memory stages with `cp.async.bulk`
// (one copy per token of the G heads' contiguous rows, completion on an
// mbarrier), so one item's loads overlap another's math and stores. n is
// padded to NPAD = 16, 32 or 64 rows; the padding is zero-filled once,
// never read from device memory, and its keys get score -inf, so p is
// exactly 0 there.
//   bf16: NPAD / 16 consumer warps per head, 16 query rows each, on the
//     tensor cores (`mma.sync.m16n8k16`, float32 accumulation): S = Q K^T
//     from `ldmatrix.x4` fragments of the staged tiles, the normalized
//     probabilities rounded into the A fragments of P V, V's B fragments
//     through `ldmatrix.x4.trans`. O goes from the accumulators straight to
//     device memory: an output tile and bulk copies (K5's way) cost shared
//     memory, hence blocks per SM, and measured slower here (PERF.md §6).
//   float32: four threads per query row on the float32 cores, the same
//     ring; each thread holds whole 16-byte vectors of its output row and
//     stores them as they are, 64 contiguous bytes per row and instruction.
// The score transform has no branches (small_score), so that the unrolled
// loops interleave every key's exponentials; the softmax normalizes by one
// reciprocal per row.
// A query row that its mask lets see no key gets the mean of its own head's
// values here; the TPU kernel gives the mean over every head's values there
// (its whole row of the (n*h)^2 bias is -1e30). No mask of the trunk has
// such a row: causal and special-token masks always allow the diagonal.
//
// Bound. At the tokenizer's time layer (B = 640, n = 16, h = 8, D = 64,
// bf16, causal) the kernel must read q, k, v and write o: 4 x 10.5 MB,
// 12.5 us at 3.35 TB/s, against 0.37 GFLOP of per-head score and PV work
// (under 1 us at the bf16 tensor-core peak). So it is bound by bytes: each
// element is read once and nothing but o is written, and the ring keeps
// loads in flight while the consumers compute and store. `small_plan`
// (ops/small_attention.py) picks G and the stages per shape.

#include "small_attn_common.cuh"

namespace {

using namespace sa;
using fa::NEG_INF;

constexpr int TENSORS = 3;    // q, k, v per stage


// ------------------------------------------------------------------ float32

template <int D, int NT>
__global__ void __launch_bounds__(MAX_THREADS) small_fwd_f32(const Params p) {
    constexpr int NPAD = 16 * NT;
    constexpr int WH = NPAD / 8;          // warps per head: four threads per query row
    constexpr int LDP = NPAD + 4;         // row stride of the probability tile
    constexpr int COLS = NPAD / 4;        // keys per thread
    constexpr int DC = D / 4;             // output columns per thread

    extern __shared__ __align__(128) uint8_t smem[];
    const Ring r = make_ring<float>(smem, p, TENSORS, NPAD, D);
    ring_init(r, p, p.G * WH);
    const int warp = threadIdx.x >> 5;
    if (warp == 0) {
        const void* src[TENSORS] = {p.q, p.k, p.v};
        produce<float, D>(r, p, src, TENSORS);
        return;
    }
    zero_padding<float>(r, p, TENSORS, p.G * WH);
    const int c = warp - 1;
    const int hl = c / WH;                                  // the head in the item
    const int tid = (c % WH) * 32 + (threadIdx.x & 31);
    const int row = tid >> 2;
    const int quad = tid & 3;
    const int ld = r.ld;
    uint64_t bits[1];
    lane_mask_bits<1>(bits, (c % WH) * 8, p);
    bits[0] >>= quad;                  // the thread's keys: quad + 4 jj
    const int keys = p.n - quad;
    float* prow = after_ring<float>(r, p, 0) + (hl * NPAD + row) * LDP;

    int j = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++j) {
        const int s = j % p.stages;
        sm90::mbar_wait(&r.full[s], (j / p.stages) & 1);
        const float* qs = tile_of<float>(r, s, 0) + hl * D;
        const float* ks = tile_of<float>(r, s, 1) + hl * D;
        const float* vs = tile_of<float>(r, s, 2) + hl * D;

        float sc[COLS];
#pragma unroll
        for (int jj = 0; jj < COLS; ++jj) sc[jj] = 0.f;
        const float* qrow = qs + row * ld;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
            for (int jj = 0; jj < COLS; ++jj) {
                const float4 k4 = *reinterpret_cast<const float4*>(ks + (quad + 4 * jj) * ld + d);
                sc[jj] = fmaf(q4.x, k4.x, sc[jj]);
                sc[jj] = fmaf(q4.y, k4.y, sc[jj]);
                sc[jj] = fmaf(q4.z, k4.z, sc[jj]);
                sc[jj] = fmaf(q4.w, k4.w, sc[jj]);
            }
        }

        float mx = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < COLS; ++jj) {
            float unused;
            sc[jj] = small_score(sc[jj], 4 * jj, bits[0], keys, p, unused);
            mx = fmaxf(mx, sc[jj]);
        }
        // the four threads of a row are adjacent lanes of one warp
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < COLS; ++jj) {
            sc[jj] = __expf(sc[jj] - mx);
            sum += sc[jj];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float inv = 1.f / sum;
#pragma unroll
        for (int jj = 0; jj < COLS; ++jj) prow[quad + 4 * jj] = sc[jj] * inv;
        __syncwarp();

        // acc[4jj + e]: output column 4 * quad + 16 * jj + e
        float acc[DC];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[jj] = 0.f;
        for (int kc = 0; kc < p.n; ++kc) {
            const float pc = prow[kc];
            const float* vrow = vs + kc * ld + 4 * quad;
#pragma unroll
            for (int jj = 0; jj < DC / 4; ++jj) {
                const float4 v4 = *reinterpret_cast<const float4*>(vrow + 16 * jj);
                acc[4 * jj + 0] = fmaf(pc, v4.x, acc[4 * jj + 0]);
                acc[4 * jj + 1] = fmaf(pc, v4.y, acc[4 * jj + 1]);
                acc[4 * jj + 2] = fmaf(pc, v4.z, acc[4 * jj + 2]);
                acc[4 * jj + 3] = fmaf(pc, v4.w, acc[4 * jj + 3]);
            }
        }
        release(r, s);

        // each thread holds whole 16-byte vectors of its row: stored as they are
        if (row < p.n) {
            float* orow = static_cast<float*>(p.o) + flat_row<D>(item, row, hl, p) + 4 * quad;
#pragma unroll
            for (int jj = 0; jj < DC / 4; ++jj) {
                *reinterpret_cast<float4*>(orow + 16 * jj) =
                    make_float4(acc[4 * jj], acc[4 * jj + 1], acc[4 * jj + 2], acc[4 * jj + 3]);
            }
        }
    }
}

// --------------------------------------------------------------------- bf16

template <int D, int NT>
__global__ void __launch_bounds__(MAX_THREADS) small_fwd_bf16(const Params p) {
    constexpr int NPAD = 16 * NT;
    constexpr int WH = NT;               // warps per head: 16 query rows each
    constexpr int KSTEPS = D / 16;       // mma k-steps over the head dim
    constexpr int NB_S = NPAD / 8;       // 8-key column blocks of the score tile
    constexpr int NB_O = D / 8;          // 8-column blocks of the output

    extern __shared__ __align__(128) uint8_t smem[];
    const Ring r = make_ring<bf16>(smem, p, TENSORS, NPAD, D);
    ring_init(r, p, p.G * WH);
    const int warp = threadIdx.x >> 5;
    if (warp == 0) {
        const void* src[TENSORS] = {p.q, p.k, p.v};
        produce<bf16, D>(r, p, src, TENSORS);
        return;
    }
    SA_TRACE_START();
    zero_padding<bf16>(r, p, TENSORS, p.G * WH);
    const int c = warp - 1;
    const int hl = c / WH;                         // the head in the item
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;                       // fragment row group
    const int t = lane & 3;                        // fragment column pair
    const int w_row = (c % WH) * 16;               // the warp's first query row
    const int ld = r.ld;
    uint64_t bits[2];
    lane_mask_bits<2>(bits, w_row, p);
    bits[0] >>= 2 * t;                 // the lane's keys: 2t + 8 nb + e
    bits[1] >>= 2 * t;
    const int keys = p.n - 2 * t;
    SA_STAMP(1);

    int j = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++j) {
        const int s = j % p.stages;
        sm90::mbar_wait(&r.full[s], (j / p.stages) & 1);
        SA_STAMP(2 + 3 * j);
        const bf16* qs = tile_of<bf16>(r, s, 0) + hl * D;
        const bf16* ks = tile_of<bf16>(r, s, 1) + hl * D;
        const bf16* vs = tile_of<bf16>(r, s, 2) + hl * D;

        // sc[nb][2r + e]: query w_row + g + 8r, key 8nb + 2t + e
        float sc[NB_S][4];
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
        }
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) {
            uint32_t qf[4];
            ldsm_a_frag(qf, qs, ld, w_row, st * 16);
#pragma unroll
            for (int nb = 0; nb < NB_S; nb += 2) {
                uint32_t kf[4];
                ldsm_b_frags(kf, ks, ld, nb * 8, st * 16);
                mma_pair(sc[nb], sc[nb + 1], qf, kf);
            }
        }

        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float unused;
                sc[nb][e] = small_score(sc[nb][e], nb * 8 + (e & 1), bits[e >> 1], keys, p, unused);
                mx[e >> 1] = fmaxf(mx[e >> 1], sc[nb][e]);
            }
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            // the four lanes of a row group hold its scores
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        }
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sc[nb][e] = __expf(sc[nb][e] - mx[e >> 1]);
                sum[e >> 1] += sc[nb][e];
            }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
            sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
        }
        const float inv[2] = {1.f / sum[0], 1.f / sum[1]};
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[nb][e] *= inv[e >> 1];
        }

        // O = round(P) . V: the accumulators of key blocks 2kk, 2kk + 1 are
        // the A fragment of keys 16kk .. 16kk + 15
        float acc[NB_O][4];
#pragma unroll
        for (int nb = 0; nb < NB_O; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < NPAD / 16; ++kk) {
            uint32_t pf[4];
            fa::acc_to_a_frag(pf, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
            for (int nb = 0; nb < NB_O; nb += 2) {
                uint32_t vf[4];
                ldsm_bt_frags(vf, vs, ld, kk * 16, nb * 8);
                mma_pair(acc[nb], acc[nb + 1], pf, vf);
            }
        }
        release(r, s);
        SA_STAMP(3 + 3 * j);
        store_frags<D>(p.o, item, w_row, hl, p, acc);
        SA_STAMP(4 + 3 * j);
    }
    SA_STAMP(15);
}

// dynamic shared memory of a launch: the ring's stages, and for float32
// the probability tile of each head
template <typename T>
size_t smem_bytes(int npad, int D, const Params& p) {
    const size_t ring = BARRIER_BYTES + p.stages * stage_bytes<T>(TENSORS, npad, p.G, D);
    if (sizeof(T) == 4) return ring + (size_t)p.G * npad * (npad + 4) * sizeof(float);
    return ring;
}

template <int D, int NT>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream, int* resident) {
    constexpr int NPAD = 16 * NT;
    if (dtype == 0) {
        return launch_persistent(small_fwd_f32<D, NT>, 32 * (1 + p.G * NPAD / 8),
                                 smem_bytes<float>(NPAD, D, p), p, stream, resident);
    }
    if (dtype == 1) {
        return launch_persistent(small_fwd_bf16<D, NT>, 32 * (1 + p.G * NT),
                                 smem_bytes<bf16>(NPAD, D, p), p, stream, resident);
    }
    return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_d(const Params& p, int dtype, cudaStream_t stream, int* resident) {
    if (p.n <= 16) return launch<D, 1>(p, dtype, stream, resident);
    if (p.n <= 32) return launch<D, 2>(p, dtype, stream, resident);
    return launch<D, 4>(p, dtype, stream, resident);
}

cudaError_t launch_any(const Params& p, int D, int dtype, cudaStream_t stream,
                       int* resident = nullptr) {
    switch (D) {
        case 16: return launch_d<16>(p, dtype, stream, resident);
        case 32: return launch_d<32>(p, dtype, stream, resident);
        case 64: return launch_d<64>(p, dtype, stream, resident);
        case 128: return launch_d<128>(p, dtype, stream, resident);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 = float32, 1 = bf16.
// mask may be null (no mask); softclamp <= 0 means no softclamp.
// heads_per_item (G, dividing h) and stages are the launch plan
// (`small_plan` in ops/small_attention.py). Returns the CUDA error code of
// the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int small_attn_fwd(const void* q, const void* k, const void* v, const uint8_t* mask,
                              void* o, int B, int n, int h, int D, int dtype, int heads_per_item,
                              int stages, float scale, float softclamp, void* stream) {
    Params p;
    if (!make_params(p, B, n, h, heads_per_item, stages, scale, softclamp)) {
        return (int)cudaErrorInvalidValue;
    }
    p.q = q;
    p.k = k;
    p.v = v;
    p.mask = mask;
    p.o = o;
    return (int)launch_any(p, D, dtype, static_cast<cudaStream_t>(stream));
}

// The blocks of the plan (heads_per_item, stages) that the card holds at
// once (blocks per SM x SMs): the persistent grid of a launch with at least
// as many items. -1 where the plan does not launch.
extern "C" int small_attn_fwd_resident(int n, int h, int D, int dtype, int heads_per_item,
                                       int stages) {
    Params p;
    int resident = 0;
    if (!make_params(p, 1, n, h, heads_per_item, stages, 1.f, 0.f) ||
        launch_any(p, D, dtype, nullptr, &resident) != cudaSuccess) {
        return -1;
    }
    return resident;
}

SA_TRACE_ENTRY(small_attn_fwd_trace)
