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
// Design. The persistent blocks and the ring of K4 (small_attn_common.cuh):
// an item is one batch row and G heads, and its q, k, v and dO rows arrive
// by `cp.async.bulk` on an mbarrier while the consumers work on the item
// before. The warps of one head own that head's gradients, so they write
// dq, dk and dv themselves: no atomics and no partial buffers, and the
// gradients are the same from run to run. The padded rows (n to NPAD) are
// zero-filled once and never read from device memory.
//   bf16: NPAD / 16 warps per head on the tensor cores (`mma.sync.m16n8k16`,
//     float32 accumulation). Each warp takes 16 query rows: S = Q K^T and
//     dP = dO V^T, then p and ds in place in the accumulators, which are
//     the A fragments of dQ = dS K (K's B fragments by `ldmatrix.trans`).
//     p and ds also go to shared memory transposed, [key][query], by
//     `stmatrix.trans`, so that after a barrier of the head's warps alone
//     (`bar.sync` with its own id; none at NPAD = 16, one warp) each warp
//     takes 16 key rows for dK = dS^T Q and dV = P^T dO, the sums over
//     queries that cross warps. dq leaves while dk and dv are computed.
//   float32: four threads per row on the float32 cores; p and ds go
//     through shared memory [query][key] to the dq (by query row) and dk/dv
//     (by key row) sums, and each thread stores whole 16-byte vectors of its
//     rows as they are.
// bf16 gradients leave through output tiles by `stmatrix` and one bulk copy
// per row, behind the next item's work (storing from the fragments freed
// the tiles' shared memory but measured slower at the world-model shapes:
// PERF.md §6); where every block takes one item at most, from the
// fragments (Params::direct_out). Padded query rows have p and ds set to 0;
// padded keys score -inf, so their p and ds are 0 as well.
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

constexpr int TENSORS = 4;    // q, k, v, dO per stage
constexpr int OUTPUTS = 3;    // dq, dk, dv

// ------------------------------------------------------------------ float32

template <int D, int NT>
__global__ void __launch_bounds__(MAX_THREADS) small_bwd_f32(const Params p) {
    constexpr int NPAD = 16 * NT;
    constexpr int WH = NPAD / 8;          // warps per head: four threads per row
    constexpr int LDP = NPAD + 4;         // row stride of the p and ds tiles
    constexpr int COLS = NPAD / 4;        // keys per thread
    constexpr int DC = D / 4;             // gradient columns per thread

    extern __shared__ __align__(128) uint8_t smem[];
    const Ring r = make_ring<float>(smem, p, TENSORS, NPAD, D);
    ring_init(r, p, p.G * WH);
    const int warp = threadIdx.x >> 5;
    if (warp == 0) {
        const void* src[TENSORS] = {p.q, p.k, p.v, p.dout};
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
    float* ps = after_ring<float>(r, p, 0) + hl * NPAD * LDP;   // [query][key]
    float* dss = ps + p.G * NPAD * LDP;
    void* const dst[OUTPUTS] = {p.o, p.dk, p.dv};

    int j = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++j) {
        const int s = j % p.stages;
        sm90::mbar_wait(&r.full[s], (j / p.stages) & 1);
        const float* qs = tile_of<float>(r, s, 0) + hl * D;
        const float* ks = tile_of<float>(r, s, 1) + hl * D;
        const float* vs = tile_of<float>(r, s, 2) + hl * D;
        const float* dos = tile_of<float>(r, s, 3) + hl * D;

        // scores and dp for keys quad + 4 * jj
        float sc[COLS], dp[COLS], dsc[COLS];
#pragma unroll
        for (int jj = 0; jj < COLS; ++jj) sc[jj] = dp[jj] = 0.f;
        const float* qrow = qs + row * ld;
        const float* grow = dos + row * ld;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qrow + d);
            const float4 g4 = *reinterpret_cast<const float4*>(grow + d);
#pragma unroll
            for (int jj = 0; jj < COLS; ++jj) {
                const float4 k4 = *reinterpret_cast<const float4*>(ks + (quad + 4 * jj) * ld + d);
                const float4 v4 = *reinterpret_cast<const float4*>(vs + (quad + 4 * jj) * ld + d);
                sc[jj] = fmaf(q4.x, k4.x, fmaf(q4.y, k4.y, fmaf(q4.z, k4.z, fmaf(q4.w, k4.w, sc[jj]))));
                dp[jj] = fmaf(g4.x, v4.x, fmaf(g4.y, v4.y, fmaf(g4.z, v4.z, fmaf(g4.w, v4.w, dp[jj]))));
            }
        }

        float mx = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < COLS; ++jj) {
            sc[jj] = small_score(sc[jj], 4 * jj, bits[0], keys, p, dsc[jj]);
            mx = fmaxf(mx, sc[jj]);
        }
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
        float dot = 0.f;   // rowsum(dp * p)
        const float inv = row < p.n ? 1.f / sum : 0.f;   // padded rows: p = 0
#pragma unroll
        for (int jj = 0; jj < COLS; ++jj) {
            sc[jj] *= inv;
            dot += dp[jj] * sc[jj];
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        float* prow = ps + row * LDP;
        float* dsrow = dss + row * LDP;
#pragma unroll
        for (int jj = 0; jj < COLS; ++jj) {
            prow[quad + 4 * jj] = sc[jj];
            dsrow[quad + 4 * jj] = sc[jj] * (dp[jj] - dot) * dsc[jj] * p.clamp.scale;
        }
        head_barrier(hl, WH);   // the head's p and ds tiles are read by every row below

        // dq: this thread's row as a query; dk, dv: the same row as a key.
        // g[i][4jj + e]: column 4 * quad + 16 * jj + e of dq, dk, dv
        float g[OUTPUTS][DC];
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) g[0][jj] = g[1][jj] = g[2][jj] = 0.f;
        for (int kc = 0; kc < p.n; ++kc) {
            const float ds_qc = dsrow[kc];                  // ds[row][kc]
            const float ds_cr = dss[kc * LDP + row];        // ds[kc][row]
            const float p_cr = ps[kc * LDP + row];          // p[kc][row]
            const float* krow = ks + kc * ld + 4 * quad;
            const float* qr = qs + kc * ld + 4 * quad;
            const float* gr = dos + kc * ld + 4 * quad;
#pragma unroll
            for (int jj = 0; jj < DC / 4; ++jj) {
                const float4 k4 = *reinterpret_cast<const float4*>(krow + 16 * jj);
                const float4 q4 = *reinterpret_cast<const float4*>(qr + 16 * jj);
                const float4 g4 = *reinterpret_cast<const float4*>(gr + 16 * jj);
                g[0][4 * jj + 0] = fmaf(ds_qc, k4.x, g[0][4 * jj + 0]);
                g[0][4 * jj + 1] = fmaf(ds_qc, k4.y, g[0][4 * jj + 1]);
                g[0][4 * jj + 2] = fmaf(ds_qc, k4.z, g[0][4 * jj + 2]);
                g[0][4 * jj + 3] = fmaf(ds_qc, k4.w, g[0][4 * jj + 3]);
                g[1][4 * jj + 0] = fmaf(ds_cr, q4.x, g[1][4 * jj + 0]);
                g[1][4 * jj + 1] = fmaf(ds_cr, q4.y, g[1][4 * jj + 1]);
                g[1][4 * jj + 2] = fmaf(ds_cr, q4.z, g[1][4 * jj + 2]);
                g[1][4 * jj + 3] = fmaf(ds_cr, q4.w, g[1][4 * jj + 3]);
                g[2][4 * jj + 0] = fmaf(p_cr, g4.x, g[2][4 * jj + 0]);
                g[2][4 * jj + 1] = fmaf(p_cr, g4.y, g[2][4 * jj + 1]);
                g[2][4 * jj + 2] = fmaf(p_cr, g4.z, g[2][4 * jj + 2]);
                g[2][4 * jj + 3] = fmaf(p_cr, g4.w, g[2][4 * jj + 3]);
            }
        }
        release(r, s);
        head_barrier(hl, WH);   // every row is done reading the p and ds tiles

        // each thread holds whole 16-byte vectors of its rows: stored as they are
        if (row < p.n) {
            const size_t off = flat_row<D>(item, row, hl, p) + 4 * quad;
#pragma unroll
            for (int i = 0; i < OUTPUTS; ++i) {
                float* orow = static_cast<float*>(dst[i]) + off;
#pragma unroll
                for (int jj = 0; jj < DC / 4; ++jj) {
                    *reinterpret_cast<float4*>(orow + 16 * jj) = make_float4(
                        g[i][4 * jj], g[i][4 * jj + 1], g[i][4 * jj + 2], g[i][4 * jj + 3]);
                }
            }
        }
    }
}

// --------------------------------------------------------------------- bf16

template <int D, int NT>
__global__ void __launch_bounds__(MAX_THREADS) small_bwd_bf16(const Params p) {
    constexpr int NPAD = 16 * NT;
    constexpr int WH = NT;               // warps per head: 16 rows each
    constexpr int LDP = NPAD + 8;        // bf16 row stride of the transposed p and ds tiles
    constexpr int KSTEPS = D / 16;       // mma k-steps over the head dim
    constexpr int NB_S = NPAD / 8;       // 8-key column blocks of a score tile
    constexpr int NB_O = D / 8;          // 8-column blocks of a gradient

    extern __shared__ __align__(128) uint8_t smem[];
    const Ring r = make_ring<bf16>(smem, p, TENSORS, NPAD, D);
    ring_init(r, p, p.G * WH);
    const int warp = threadIdx.x >> 5;
    if (warp == 0) {
        const void* src[TENSORS] = {p.q, p.k, p.v, p.dout};
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
    const int w_row = (c % WH) * 16;               // the warp's first row
    const int qi[2] = {w_row + g, w_row + g + 8};
    const int ld = r.ld;
    uint64_t bits[2];
    lane_mask_bits<2>(bits, w_row, p);
    bits[0] >>= 2 * t;                 // the lane's keys: 2t + 8 nb + e
    bits[1] >>= 2 * t;
    const int keys = p.n - 2 * t;
    SA_STAMP(1);
    bf16* dqs = after_ring<bf16>(r, p, 0) + hl * D;
    bf16* dks = after_ring<bf16>(r, p, 1) + hl * D;
    bf16* dvs = after_ring<bf16>(r, p, 2) + hl * D;
    // [key][query], after the output tiles
    bf16* pT = after_ring<bf16>(r, p, p.direct_out ? 0 : OUTPUTS) + hl * NPAD * LDP;
    bf16* dsT = pT + p.G * NPAD * LDP;

    int j = 0;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x, ++j) {
        const int s = j % p.stages;
        sm90::mbar_wait(&r.full[s], (j / p.stages) & 1);
        SA_STAMP(2 + 3 * j);
        const bf16* qs = tile_of<bf16>(r, s, 0) + hl * D;
        const bf16* ks = tile_of<bf16>(r, s, 1) + hl * D;
        const bf16* vs = tile_of<bf16>(r, s, 2) + hl * D;
        const bf16* dos = tile_of<bf16>(r, s, 3) + hl * D;

        // sc[nb][2r + e], dp[nb][2r + e]: query qi[r], key 8nb + 2t + e
        float sc[NB_S][4], dp[NB_S][4], dsc[NB_S][4];
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[nb][e] = dp[nb][e] = 0.f;
        }
#pragma unroll
        for (int st = 0; st < KSTEPS; ++st) {
            uint32_t qf[4], gf[4];
            ldsm_a_frag(qf, qs, ld, w_row, st * 16);
            ldsm_a_frag(gf, dos, ld, w_row, st * 16);
#pragma unroll
            for (int nb = 0; nb < NB_S; nb += 2) {
                uint32_t kf[4], vf[4];
                ldsm_b_frags(kf, ks, ld, nb * 8, st * 16);
                ldsm_b_frags(vf, vs, ld, nb * 8, st * 16);
                mma_pair(sc[nb], sc[nb + 1], qf, kf);
                mma_pair(dp[nb], dp[nb + 1], gf, vf);
            }
        }

        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sc[nb][e] = small_score(sc[nb][e], nb * 8 + (e & 1), bits[e >> 1], keys, p,
                                        dsc[nb][e]);
                mx[e >> 1] = fmaxf(mx[e >> 1], sc[nb][e]);
            }
        }
        float sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
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
        // padded query rows: p = 0
        const float inv[2] = {qi[0] < p.n ? 1.f / sum[0] : 0.f, qi[1] < p.n ? 1.f / sum[1] : 0.f};
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int rr = e >> 1;
                sc[nb][e] *= inv[rr];
                dot[rr] += dp[nb][e] * sc[nb][e];
            }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            dot[rr] += __shfl_xor_sync(0xffffffffu, dot[rr], 1);
            dot[rr] += __shfl_xor_sync(0xffffffffu, dot[rr], 2);
        }
        // ds into dp; p and ds, rounded to bf16, into the transposed tiles:
        // the accumulators of key blocks nb, nb + 1 are four 8 x 8
        // matrices [query][key], stored [key][query] by `stmatrix.trans`
        const int mi = lane >> 3;
        const int t_off = ((mi >> 1) * 8 + (lane & 7)) * LDP + w_row + (mi & 1) * 8;
#pragma unroll
        for (int nb = 0; nb < NB_S; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                dp[nb][e] = sc[nb][e] * (dp[nb][e] - dot[e >> 1]) * dsc[nb][e] * p.clamp.scale;
            }
        }
#pragma unroll
        for (int nb = 0; nb < NB_S; nb += 2) {
            stmatrix_x4_trans(pT + nb * 8 * LDP + t_off, fa::pack_bf16x2(sc[nb][0], sc[nb][1]),
                              fa::pack_bf16x2(sc[nb][2], sc[nb][3]),
                              fa::pack_bf16x2(sc[nb + 1][0], sc[nb + 1][1]),
                              fa::pack_bf16x2(sc[nb + 1][2], sc[nb + 1][3]));
            stmatrix_x4_trans(dsT + nb * 8 * LDP + t_off, fa::pack_bf16x2(dp[nb][0], dp[nb][1]),
                              fa::pack_bf16x2(dp[nb][2], dp[nb][3]),
                              fa::pack_bf16x2(dp[nb + 1][0], dp[nb + 1][1]),
                              fa::pack_bf16x2(dp[nb + 1][2], dp[nb + 1][3]));
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
            for (int nb = 0; nb < NB_O; nb += 2) {
                uint32_t kf[4];
                ldsm_bt_frags(kf, ks, ld, kk * 16, nb * 8);
                mma_pair(acc[nb], acc[nb + 1], dsf, kf);
            }
        }
        head_barrier(hl, WH);   // every warp's rows of pT and dsT are written

        // dq out while dk and dv are computed; its tile's last copies (an
        // item ago) were committed before that item's dk/dv group
        await_out_tile<1>();
        write_rows<D>(p.o, dqs, ld, item, w_row, hl, p, acc);
        bulk_commit();
        SA_STAMP(3 + 3 * j);

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
            ldsm_a_frag(dsf, dsT, LDP, w_row, kk * 16);
            ldsm_a_frag(pf, pT, LDP, w_row, kk * 16);
#pragma unroll
            for (int nb = 0; nb < NB_O; nb += 2) {
                uint32_t qf[4], gf[4];
                ldsm_bt_frags(qf, qs, ld, kk * 16, nb * 8);
                ldsm_bt_frags(gf, dos, ld, kk * 16, nb * 8);
                mma_pair(dk[nb], dk[nb + 1], dsf, qf);
                mma_pair(dv[nb], dv[nb + 1], pf, gf);
            }
        }
        release(r, s);
        head_barrier(hl, WH);   // every warp is done reading pT and dsT

        // the dk/dv tiles' last copies are all groups but the dq one above
        await_out_tile<1>();
        write_rows<D>(p.dk, dks, ld, item, w_row, hl, p, dk);
        write_rows<D>(p.dv, dvs, ld, item, w_row, hl, p, dv);
        bulk_commit();
        SA_STAMP(4 + 3 * j);
    }
    bulk_wait_read_all();
    SA_STAMP(15);
}

// dynamic shared memory of a launch: the ring's stages, for bf16 the three
// gradient tiles unless p.direct_out, and each head's p and ds tiles
template <typename T>
size_t smem_bytes(int npad, int D, const Params& p) {
    const int ldp = npad + 16 / (int)sizeof(T);
    const int outputs = sizeof(T) == 4 || p.direct_out ? 0 : OUTPUTS;
    return BARRIER_BYTES + (p.stages * TENSORS + outputs) * stage_bytes<T>(1, npad, p.G, D) +
           (size_t)2 * p.G * npad * ldp * sizeof(T);
}

template <int D, int NT>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream, int* resident) {
    constexpr int NPAD = 16 * NT;
    if (dtype == 0) {
        return launch_persistent(small_bwd_f32<D, NT>, 32 * (1 + p.G * NPAD / 8),
                                 smem_bytes<float>(NPAD, D, p), p, stream, resident);
    }
    if (dtype == 1) {
        // the grid with output tiles; where it holds every item at once, no
        // block has a next item to hide its stores behind: store directly
        const int threads = 32 * (1 + p.G * NT);
        const size_t smem = smem_bytes<bf16>(NPAD, D, p);
        if (resident == nullptr) {
            const int blocks = resident_blocks(
                reinterpret_cast<const void*>(small_bwd_bf16<D, NT>), threads, smem);
            if (blocks > 0 && p.items <= blocks) {
                Params direct = p;
                direct.direct_out = 1;
                const size_t less = smem_bytes<bf16>(NPAD, D, direct);
                return launch_persistent(small_bwd_bf16<D, NT>, threads, less, direct, stream,
                                         nullptr);
            }
        }
        return launch_persistent(small_bwd_bf16<D, NT>, threads, smem, p, stream, resident);
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
// (`small_plan` in ops/small_attention.py). Writes dq, dk and dv. Returns
// the CUDA error code of the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int small_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const uint8_t* mask, void* dq, void* dk, void* dv, int B, int n,
                              int h, int D, int dtype, int heads_per_item, int stages, float scale,
                              float softclamp, void* stream) {
    Params p;
    if (!make_params(p, B, n, h, heads_per_item, stages, scale, softclamp)) {
        return (int)cudaErrorInvalidValue;
    }
    p.q = q;
    p.k = k;
    p.v = v;
    p.dout = dout;
    p.mask = mask;
    p.o = dq;
    p.dk = dk;
    p.dv = dv;
    return (int)launch_any(p, D, dtype, static_cast<cudaStream_t>(stream));
}

// The blocks of the plan (heads_per_item, stages) that the card holds at
// once (blocks per SM x SMs): the persistent grid of a launch with at least
// as many items. -1 where the plan does not launch.
extern "C" int small_attn_bwd_resident(int n, int h, int D, int dtype, int heads_per_item,
                                       int stages) {
    Params p;
    int resident = 0;
    if (!make_params(p, 1, n, h, heads_per_item, stages, 1.f, 0.f) ||
        launch_any(p, D, dtype, nullptr, &resident) != cudaSuccess) {
        return -1;
    }
    return resident;
}

SA_TRACE_ENTRY(small_attn_bwd_trace)
