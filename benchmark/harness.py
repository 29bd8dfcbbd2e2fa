"""What every cell's run shares: the data files, the weights and draws the
benchmark makes, the timed window, the profiler's trace and its reduction,
and the comparison that decides `correct`.

A run: set-up (the cell's entry builds the program's object from the seed
and drives it through its first calls, which also compile and warm every
shape), the window (the entry's call back to back for the run's seconds; or,
traced, a fixed number of calls under torch.profiler), the check (the
program's readings against the plain reference's, after the program's state
is freed) and the report (one JSON line). Everything that belongs to one
configuration, traffic mix, entry point or per-layer metric is a file of its
own, found by name.
"""
from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from .flops import PEAK_FLOPS

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN_MODULES = frozenset({'jax', 'jaxlib', 'flax', 'optax', 'dreamer4_tpu'})
DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


# ------------------------------------------------------------------ files

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / 'BENCHMARK.json')


def workload_file(name: str) -> dict:
    return load_json(BENCH / 'workloads' / f'{name}.json')


def config_file(name: str) -> dict:
    return load_json(BENCH / 'configs' / f'{name}.json')


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_module(entry: str):
    return load_module(BENCH / 'entries' / f'{entry}.py', f'benchmark_entry_{entry}')


def metric_reader(name: str):
    return load_module(BENCH / 'metrics' / f'{name}.py',
                       'benchmark_metric_' + name.replace('.', '_'))


def forbidden_loaded(modules) -> list[str]:
    """The modules whose top-level name, taken whole, is JAX's or the JAX
    package's."""
    return sorted({m for m in modules if m.split('.')[0] in FORBIDDEN_MODULES})


# ----------------------------------------------------------- seeds, data

def sub_seed(seed: int, purpose: str) -> int:
    """A seed of its own for each use of the run's seed."""
    h = 1469598103934665603
    for ch in f'{seed}:{purpose}':
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def weight_std(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a parameter the benchmark makes, by its role: norm
    scales 1 + N(0, 0.02); QK-norm gammas and biases N(0, 0.02); a linear
    map or embedding table N(0, 1 / fan_in) (an (out, in) `.weight`, an
    (in, out) or (heads, in, out) `.kernel`, the action unembedding); the
    learned agent, action and reward embeddings N(0, 1); the latent
    prediction at a quarter of a linear map's scale, so that predicted
    latents lie in the tokenizer's tanh range as a trained model's do; the
    rest (register, mask and latent tokens) N(0, 0.02)."""
    last = name.rsplit('.', 1)[-1]
    if last in ('scale', 'norm_scale'):
        return 1.0, 0.02
    if last in ('gamma', 'bias'):
        return 0.0, 0.02
    if name.endswith('_learned_embed'):
        return 0.0, 1.0
    if last == 'kernel':
        return 0.0, 1.0 / math.sqrt(shape[0] if len(shape) == 2 else shape[1])
    if last == 'weight' and len(shape) == 2:
        std = 1.0 / math.sqrt(shape[1])
        return 0.0, std * 0.25 if name == 'to_latent_pred.weight' else std
    if last == 'discrete_action_unembed':
        return 0.0, 1.0 / math.sqrt(shape[-1])
    return 0.0, 0.02


def make_weights(named_params, seed: int, device) -> dict[str, torch.Tensor]:
    """float32 weights for every named parameter, from one normal draw on the
    device, scaled per parameter (`weight_std`)."""
    shapes = [(n, tuple(p.shape)) for n, p in named_params]
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=generator(seed, 'weights', device), device=device)
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        mean, std = weight_std(name, shape)
        out[name] = flat[offset:offset + n].view(shape) * std + mean
        offset += n
    return out


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: dict):
    for name, p in model.named_parameters():
        p.copy_(weights[name])


class DrawTape:
    """Stands in for a module's `draw` while the first train steps run: makes
    each draw from the benchmark's own generator, in the distribution the
    kind names, and keeps a copy of it per step for the reference. A draw
    whose leading dim is not the cell's batch (a program that left rows
    out) is made at the whole batch, and its first rows are handed over."""

    def __init__(self, seed: int, device, batch: int):
        self.gen = generator(seed, 'draws', device)
        self.batch = batch
        self.steps: list[dict] = []

    def new_step(self):
        self.steps.append({})

    def __call__(self, kind, shape, *, generator=None, device=None, low=0, high=0, prob=None):
        shape = tuple(shape)
        rows = shape[0] if shape else None
        full = (self.batch, *shape[1:]) if shape else shape
        step = self.steps[-1]
        if kind in step:
            raise ValueError(f'a second draw of {kind} in one step')
        if kind in ('step_sizes_log2', 'signal_levels', 'time_indices'):
            t = torch.randint(int(low), int(high), full, generator=self.gen, device=device)
        elif kind == 'noise':
            t = torch.randn(full, generator=self.gen, device=device)
        elif kind == 'mask_prob':
            t = torch.rand(full, generator=self.gen, device=device) * (high - low) + low
        elif kind == 'patch_mask':
            u = torch.rand(full, generator=self.gen, device=device)
            step[kind] = u < step['mask_prob'][..., None, None]
            return u[:rows] < prob
        else:
            raise ValueError(f'the benchmark makes no draw of kind {kind}')
        step[kind] = t.clone()
        return t[:rows] if shape else t


# -------------------------------------------------------------- readings

def leaf_norms(tensors: dict) -> dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, norms))


def first_gradients(optimizer) -> dict[str, torch.Tensor]:
    """The clipped gradient each parameter's optimizer state holds after the
    first step of `MuonAdamAtan2`: Muon's momentum is the gradient itself,
    Adam's first moment (1 - b1) times it."""
    out = {}
    for group in optimizer.param_groups:
        for name, p in zip(group['names'], group['params']):
            state = optimizer.state[p]
            if not state:                # a step that kept no state moved nothing
                out[name] = torch.zeros_like(p)
            elif group['kind'] == 'muon':
                out[name] = state['momentum']
            else:
                out[name] = state['mu'] / (1.0 - group['b1'])
    return out


def training_gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers compared in a training cell, each the program's reading
    against the reference's:
    - loss_gap: the worst of the first steps' losses, relative;
    - <term>_gap: the same of each loss term the entry reads apart;
    - grad_gap: over the leaves, the worst gap between the norms of the
      first clipped gradient, over the reference's norm of that leaf or of
      the median leaf, whichever is larger;
    - change_gap: the same of the parameters' change over the steps, over
      the leaves whose reference gradient is at least a thousandth of the
      median leaf's (the others move under Adam by round-off alone)."""
    rel = lambda ps, rs: max(abs(p - r) / abs(r) for p, r in zip(ps, rs))
    out = {'loss_gap': rel(prog['losses'], ref['losses'])}
    for term in ref['terms']:
        out[f'{term}_gap'] = rel(prog['terms'][term], ref['terms'][term])
    g_ref = ref['grad_norms']
    med_g = statistics.median(v for v in g_ref.values() if v > 0)
    out['grad_gap'] = max(abs(prog['grad_norms'][n] - v) / max(v, med_g)
                          for n, v in g_ref.items())
    moved = [n for n, v in g_ref.items() if v >= 1e-3 * med_g]
    c_ref = ref['change_norms']
    med_c = statistics.median(c_ref[n] for n in moved)
    out['change_gap'] = max(abs(prog['change_norms'][n] - c_ref[n]) / max(c_ref[n], med_c)
                            for n in moved)
    return out


def reference_training(weights: dict, loss_fn, steps: int, clip: float, lr: float) -> dict:
    """The reference trainer's readings after `steps` steps from `weights`:
    losses (and the loss terms read apart), the first clipped gradient's
    leaf norms, each leaf's change. loss_fn(params, i) -> (step i's loss,
    {term: value})."""
    from .reference.ops import float32_matmuls
    from .reference.optim import MuonAdamAtan2

    params = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    opt = MuonAdamAtan2(params, lr=lr, clip=clip)
    losses, terms, grad_norms = [], {}, None
    with float32_matmuls():
        for i in range(steps):
            loss, step_terms = loss_fn(params, i)
            names = list(params)
            grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
            grads = {n: (g if g is not None else torch.zeros_like(params[n]))
                     for n, g in zip(names, grads)}
            grads = opt.clipped(grads)
            if i == 0:
                grad_norms = leaf_norms(grads)
            opt.step(grads)
            losses.append(float(loss.detach()))
            for k, v in step_terms.items():
                terms.setdefault(k, []).append(float(v.detach()))
            del grads, loss
    change = {n: params[n].detach() - weights[n] for n in params}
    return {'losses': losses, 'terms': terms, 'grad_norms': grad_norms,
            'change_norms': leaf_norms(change)}


def free_device_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- window

def synchronize(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_window(cell, seconds: float, device) -> dict:
    """The entry's call back to back until `seconds` have passed on the host
    clock; every call issued counts, and the window ends when the device has
    finished them. Each call's time is read from CUDA events recorded
    between calls (no synchronize inside the window)."""
    cuda = device.type == 'cuda'
    synchronize(device)
    records, events = [], []
    t0 = time.perf_counter()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    while time.perf_counter() - t0 < seconds or not records:
        records.append(cell.step())
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            events.append(time.perf_counter())
    synchronize(device)
    elapsed = time.perf_counter() - t0
    if cuda:
        marks = [start, *events]
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks = [t0, *events]
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return {'records': records, 'elapsed_s': elapsed, 'step_ms': step_ms}


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between closest ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ------------------------------------------------------------------ trace

def _is_launch(name: str) -> bool:
    return 'LaunchKernel' in name or name.startswith('cudaLaunchCooperativeKernel')


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (`cudaLaunchKernel`, `cuLaunchKernelEx`)."""
    return name.startswith('cuda') or (name.startswith('cu') and name[2:3].isupper())


def launch_counts() -> dict[str, int]:
    """The port's own kernel launch counters, by `<module>.<NAME>`: every
    `*_LAUNCHES` of a loaded `dreamer4_torch.ops` module (a table of counts
    by variant is summed)."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not mod_name.startswith('dreamer4_torch.ops.'):
            continue
        for attr, v in vars(mod).items():
            if attr.endswith('_LAUNCHES'):
                key = f"{mod_name.rsplit('.', 1)[1]}.{attr}"
                out[key] = sum(v.values()) if isinstance(v, dict) else int(v)
    return out


def run_traced(cell, calls: int, device) -> dict:
    """`calls` calls of the entry under torch.profiler (CPU and CUDA
    activity), reduced to what the per-layer readers take: the device's
    kernels and copies, the host's launches and ranges, the busy and idle
    time of the traced window, and how far the port's launch counters
    (`launch_counts`) moved over the traced calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    synchronize(device)
    records = []
    counted = launch_counts()
    with profile(activities=acts) as prof:
        for _ in range(calls):
            with record_function('benchmark.call'):
                records.append(cell.step())
        synchronize(device)
    counted = {k: v - counted.get(k, 0) for k, v in launch_counts().items()}
    events = prof.profiler.kineto_results.events()

    device_ev, host_ev = [], []
    for e in events:
        name = e.name()
        annotation = getattr(e, 'is_user_annotation', lambda: False)()
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                device_ev.append((e.start_ns(), e.end_ns(), name))
        elif e.device_type() == DeviceType.CPU:
            host_ev.append((e.start_ns(), e.end_ns(), name))
    calls_ev = sorted(e for e in host_ev if e[2] == 'benchmark.call')
    # the traced window in the trace's clock: from the first call's start
    lo = calls_ev[0][0] if calls_ev else min((e[0] for e in host_ev), default=0)
    hi = max([lo] + [e[1] for e in device_ev] + [e[1] for e in calls_ev])

    intervals = sorted((max(s, lo), min(t, hi)) for s, t, _ in device_ev if t > lo and s < hi)
    merged = []
    for s, t in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_ns = sum(t - s for s, t in merged)

    # idle gaps, named by the innermost host op running at each gap's middle
    ops = sorted(e for e in host_ev if not _is_runtime(e[2]) and e[2] != 'benchmark.call')
    starts = [e[0] for e in ops]
    gaps: dict[str, float] = {}
    bounds = [lo] + [x for s, t in merged for x in (s, t)] + [hi]
    for a, b in zip(bounds[0::2], bounds[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = '(no host op)'
        for j in range(i, max(i - 400, -1), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9

    by_kernel: dict[str, float] = {}
    for s, t, name in device_ev:
        by_kernel[name] = by_kernel.get(name, 0.0) + (t - s) / 1e9
    host_ranges: dict[str, float] = {}
    for s, t, name in host_ev:
        host_ranges[name] = host_ranges.get(name, 0.0) + (t - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        'records': records,
        'trace_window_s': (hi - lo) / 1e9,
        'busy_s': busy_ns / 1e9,
        'kernels': [(name, (t - s) / 1e9) for s, t, name in device_ev],
        'launches': sum(1 for _, _, name in host_ev if _is_launch(name)),
        'launch_counts': counted,
        'host_ranges_s': host_ranges,
        'breakdown': {'device_ops': top(by_kernel), 'idle_gaps': top(gaps)},
    }


# --------------------------------------------------------------- readers

def rate(ctx: dict) -> float | None:
    """The window's work (each call's `work`) over its host time."""
    if 'elapsed_s' not in ctx:
        return None
    return sum(r['work'] for r in ctx['records']) / ctx['elapsed_s']


def idle_pct(ctx: dict) -> float | None:
    """The device's idle share of the traced window: 1 - the union of the
    intervals in which a kernel, copy or memset ran, over the window."""
    if 'busy_s' not in ctx or not ctx['kernels']:
        return None
    return 100.0 * (1.0 - ctx['busy_s'] / ctx['trace_window_s'])


def mfu_pct(ctx: dict) -> float | None:
    """The model FLOPs of the traced calls (each call's `flops`, from
    `benchmark/flops.py`) over the traced window times the bf16 peak."""
    if 'trace_window_s' not in ctx:
        return None
    return 100.0 * sum(r['flops'] for r in ctx['records']) / (
        ctx['trace_window_s'] * PEAK_FLOPS['bfloat16'])


def launches_per(ctx: dict, unit: str | None = None) -> float | None:
    """The host's kernel launches in the trace per traced call, or per the
    calls' `unit` summed."""
    if 'launches' not in ctx or not ctx['kernels']:
        return None
    per = len(ctx['records']) if unit is None else sum(r[unit] for r in ctx['records'])
    return ctx['launches'] / per


def roofline_pct(ctx: dict, families: dict[str, str]) -> float | None:
    """Kernels against their least time. `families` maps the pattern of a
    kernel family's names in the trace to the port's launch counter of it
    (`launch_counts`). Each launch the port counted over the traced calls
    takes the least time the cell's entry gives for that family
    (`bounds_s`, from the configuration's shapes); their sum is over the
    traced kernels' own device time. None where the port launched none, and
    where a family's kernels in the trace are not as many as its counted
    launches (a lost event or a miscount: no share stands on that)."""
    if 'launch_counts' not in ctx:
        return None
    bound = device = 0.0
    for pattern, counter in families.items():
        count = ctx['launch_counts'].get(counter, 0)
        held = [d for name, d in ctx['kernels'] if pattern in name]
        if len(held) != count:
            print(f'# {pattern}: {len(held)} kernels traced, {count} launches counted '
                  f'({counter}); no roofline', file=sys.stderr, flush=True)
            return None
        if count:
            device += sum(held)
            bound += count * ctx['bounds_s'][pattern]
    return 100.0 * bound / device if device > 0 else None


# ----------------------------------------------------------------- faults

class patched:
    """Replaces `owner.attr` by `make(original)` inside the block: a fault
    planted under the timed path for the checks of the comparison."""

    def __init__(self, owner, attr: str, make):
        self.owner, self.attr, self.make = owner, attr, make

    def __enter__(self):
        self.original = getattr(self.owner, self.attr)
        setattr(self.owner, self.attr, self.make(self.original))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.original)
        return False


def frozen_optimizer():
    """The optimizer's step returns its state unchanged."""
    from dreamer4_torch.train.optim import MuonAdamAtan2

    return patched(MuonAdamAtan2, 'step', lambda original: lambda self, closure=None: None)
