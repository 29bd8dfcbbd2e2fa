"""Operations and bytes from shapes alone: the model FLOPs of a train step or
a rollout (the numerator of the MFU metrics) and the least time of the
attention kernels' work (the numerator of the roofline metrics).

A FLOP count is 2 per multiply-add of the model's matrix products: every
projection, the attention scores and their weighted sums over the (query,
key) pairs the masks allow, the attention pools over each token's stack of
hiddens, and the heads the step uses. Norms, softmaxes and other elementwise
work are not counted. A backward pass counts twice its forward; work redone
to save memory is not counted. The attention bounds are the arithmetic of the
port's `chip_smoke.py` (`roofline`, `attention_bound_ms`, `backward_bound_ms`,
`small_bound_ms`), here on shapes instead of tensors.
"""
from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM5 (dense, no sparsity), at 700 W
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12
# the exponential unit: 16 operations per clock on each of the 132 SMs at the
# 1,980 MHz maximum SM clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9
POOL_HEADS, POOL_DIM_HEAD = 4, 64
ELEM = {'bfloat16': 2, 'float32': 4}


# ------------------------------------------------------------------ model

def ff_inner(dim: int) -> int:
    """The GLU feedforward's inner width at expansion 4."""
    return int(dim * 4.0 * (2 / 3))


def space_pairs(s: int, num_special: int, only_itself: bool) -> int:
    """(query, key) pairs a frame's space attention allows: the other tokens
    do not see the special ones, or the special ones see only each other."""
    ns = num_special
    if only_itself:
        return (s - ns) * s + ns * ns
    return (s - ns) * (s - ns) + ns * s


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def trunk_flops(*, rows: int, frames: int, s: int, dim: int, depth: int, heads: int,
                dim_head: int, time_every: int, num_special: int, only_itself: bool = False,
                time_pairs: int | None = None) -> int:
    """One forward of the axial trunk over `rows` sequences of `frames`
    frames of `s` tokens; `time_pairs` is the (query, key) pairs of one
    sequence's time attention (causal over the frames by default)."""
    n = rows * frames * s
    hd = heads * dim_head
    f = ff_inner(dim)
    tp = causal_pairs(frames) if time_pairs is None else time_pairs
    sp = space_pairs(s, num_special, only_itself)
    attn_proj = 2 * n * dim * hd * 4 + 2 * n * dim * heads * 2     # q k v out, mix, gates
    ff = 2 * n * dim * 2 * f + 2 * n * f * dim
    total = 2 * n * dim * hd                                       # the value residual
    for i in range(depth):
        is_time = (i + 1) % time_every == 0
        pairs = rows * s * heads * tp if is_time else rows * frames * heads * sp
        total += attn_proj + ff + 4 * dim_head * pairs
    ph = POOL_HEADS * POOL_DIM_HEAD
    per_pool = lambda L: n * (2 * dim * ph + 2 * 2 * L * dim * ph + 2 * 2 * L * ph
                              + 2 * dim * POOL_HEADS + 2 * ph * dim)
    total += sum(per_pool(3 + 2 * i) for i in range(depth - 1)) + per_pool(1 + 2 * depth)
    ns = num_special
    if ns > 0 and not only_itself:
        nf = rows * frames
        total += nf * (2 * ns * dim * hd + 2 * 2 * (s - ns) * dim * hd
                       + 4 * dim_head * heads * ns * (s - ns) + 2 * ns * dim * heads
                       + 2 * ns * hd * dim + 2 * ns * dim * 2 * f + 2 * ns * f * dim)
    return total


def wm_tokens_per_frame(kw: dict) -> int:
    """flow + spatial + registers + action + agent tokens."""
    return 1 + kw['num_spatial_tokens'] + kw['num_register_tokens'] + 1 + 1


def wm_predict_flops(kw: dict, rows: int, frames: int, time_pairs: int | None = None) -> int:
    """One pass of the world model's prediction: the latents' map into the
    spatial tokens, the trunk, the map back."""
    s = wm_tokens_per_frame(kw)
    d, dl, n = kw['dim'], kw['dim_latent'], kw['num_latent_tokens']
    io = 2 * 2 * rows * frames * n * dl * d
    return io + trunk_flops(rows=rows, frames=frames, s=s, dim=d, depth=kw['depth'],
                            heads=kw['attn_heads'], dim_head=kw['attn_dim_head'],
                            time_every=kw['time_block_every'], num_special=1,
                            time_pairs=time_pairs)


def wm_policy_flops(kw: dict, positions: int, heads_used: int) -> int:
    """The policy MLP and the action unembedding of `heads_used` of its
    prediction heads."""
    d = kw['dim']
    na = sum(kw['num_discrete_actions'])
    return positions * (2 * (d * 4 * d + 3 * (4 * d) ** 2) + 2 * 4 * d * na * heads_used)


def wm_value_flops(kw: dict, positions: int) -> int:
    d = kw['dim']
    return positions * 2 * (d * 4 * d + 2 * (4 * d) ** 2 + 4 * d * 255)


def wm_train_step_flops(kw: dict, batch: int, frames: int, shortcut: bool) -> int:
    """Forward and backward of the training loss (3x the forward), plus the
    two prediction passes of a shortcut step's target (forward only)."""
    mtp = kw['multi_token_pred_len']
    heads = (batch * (frames - 1) * 2 * mtp * kw['dim'] * 255
             + wm_policy_flops(kw, batch * frames, mtp))
    fwd = wm_predict_flops(kw, batch, frames) + heads
    return 3 * fwd + (2 * wm_predict_flops(kw, batch, frames) if shortcut else 0)


def wm_rollout_flops(kw: dict, batch: int, prompt: int, time_steps: int, num_steps: int) -> int:
    """A rollout: the prompt pass, then per dreamed frame `num_steps`
    denoising passes and the clean pass over one frame against the frames
    before it, and the reward, policy and value heads once."""
    total = wm_predict_flops(kw, batch, prompt)
    d = kw['dim']
    for i in range(prompt, time_steps):
        total += (num_steps + 1) * wm_predict_flops(kw, batch, 1, time_pairs=i + 1)
        total += batch * 2 * d * 255 + wm_policy_flops(kw, batch, 1) + wm_value_flops(kw, batch)
    return total


def tok_train_step_flops(kw: dict, batch: int, frames: int) -> int:
    """Forward and backward (3x) of the tokenizer's training loss."""
    d, p, c = kw['dim'], kw['patch_size'], kw.get('channels', 3)
    hp, wp = kw['image_height'] // p, kw['image_width'] // p
    n_lat = kw['num_latent_tokens']
    nf = batch * frames
    s = hp * wp + n_lat
    common = dict(rows=batch, frames=frames, s=s, dim=d, heads=kw.get('attn_heads', 8),
                  dim_head=kw.get('attn_dim_head', 64), time_every=kw['time_block_every'],
                  num_special=n_lat)
    trunks = (trunk_flops(depth=kw['encoder_depth'], **common)
              + trunk_flops(depth=kw['decoder_depth'], only_itself=True, **common))
    patch = p * p * c
    maps = (2 * 2 * nf * hp * wp * patch * d          # the clean and noised patch projections
            + 2 * 2 * nf * n_lat * d * kw['dim_latent']
            + 2 * nf * hp * wp * d * patch             # tokens back to patches
            + 2 * hp * wp * (2 * 2 * d + (2 * d) ** 2 + 2 * d * d))   # the position MLP
    return 3 * (trunks + maps)


# --------------------------------------------------------------- bounds

def roofline_s(bytes_moved: float, ops: float, dtype: str, transcendentals: float = 0.0) -> float:
    """The least time of the work: the largest of the bytes at the memory
    rate, the operations at the peak of `dtype` and the transcendentals on
    the exponential unit."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype],
               transcendentals / SFU_OPS_PER_S)


def flash_bounds_s(*, B: int, heads: int, n: int, dim_head: int, dtype: str,
                   softclamp: bool = True) -> dict:
    """Least times of K1 (with and without its LSE), K2 and K3 on causal
    self-attention of B rows of n positions: q and o, the k and v rows read
    once; 4 D operations per allowed pair for K1, 6 D for K2 (s, dp, dq),
    8 D for K3 (s, dp, dv, dk); 2 transcendentals per pair with a softclamp
    (tanh, exp), else 1."""
    e = ELEM[dtype]
    D = dim_head
    pairs = causal_pairs(n) * B * heads
    tr = pairs * (2 if softclamp else 1)
    rows = B * heads * n * D * e
    fwd = 2 * rows + 2 * rows
    lse = B * heads * n * 4
    dq = 3 * rows + 2 * rows + lse + rows + lse
    dkv = 2 * rows + 2 * rows + 2 * lse + 2 * rows
    return {'k1': roofline_s(fwd, 4 * D * pairs, dtype, tr),
            'k1_lse': roofline_s(fwd + lse, 4 * D * pairs, dtype, tr),
            'k2': roofline_s(dq, 6 * D * pairs, dtype, tr),
            'k3': roofline_s(dkv, 8 * D * pairs, dtype, tr)}


def small_bounds_s(*, B: int, n: int, heads: int, dim_head: int, dtype: str,
                   allowed_pairs: int) -> dict:
    """Least times of K4 (q, k, v read, o written; 4 D operations per
    allowed pair of each head) and K5 (q, k, v, dO read, dq, dk, dv written;
    10 D), the (n, n) mask read once; as `small_bound_ms`, without the
    exponential unit."""
    e = ELEM[dtype]
    flat = B * n * heads * dim_head * e
    return {'k4': roofline_s(4 * flat + n * n, 4 * dim_head * allowed_pairs * B * heads, dtype),
            'k5': roofline_s(7 * flat + n * n, 10 * dim_head * allowed_pairs * B * heads, dtype)}
