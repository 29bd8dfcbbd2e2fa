"""What the benchmark loads: nothing of JAX or the JAX package in a run, and
nothing of the port in the reference; top-level module names compared whole
(`dreamer4_torch` begins with `dreamer4_t`). And a run without a CUDA device
prints no result."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def run_python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)


def test_names_are_compared_whole():
    assert harness.forbidden_loaded(['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen',
                                     'optax', 'dreamer4_tpu.models']) == [
        'dreamer4_tpu.models', 'flax.linen', 'jax', 'jax.numpy', 'jaxlib.xla_client', 'optax']
    assert harness.forbidden_loaded(['dreamer4_torch', 'dreamer4_torch.models', 'jaxtyping',
                                     'flaxen', 'optaxx', 'dreamer4_tpux']) == []


def test_a_run_loads_no_jax():
    """A whole run of a cell (the CPU stands in for the card) and every
    entry and metric reader the benchmark has."""
    code = f'''
import sys, json, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness, run
from benchmark.tests.tiny import tiny_cell_config, tiny_workload
for cell in ('wm_train_long', 'tok_train', 'wm_imagine'):
    run.run(cell, 1, 0.1, cell == 'tok_train', torch.device('cpu'),
            config=tiny_cell_config(cell), workload=tiny_workload(cell))
for p in (harness.BENCH / 'metrics').glob('*.py'):
    harness.metric_reader(p.stem)
for p in (harness.BENCH / 'entries').glob('*.py'):
    harness.entry_module(p.stem)
import benchmark.calibrate
print(json.dumps(sorted(sys.modules)))
'''
    out = run_python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert 'dreamer4_torch' in loaded
    assert harness.forbidden_loaded(loaded) == []


def test_the_reference_loads_nothing_of_the_port():
    code = '''
import sys, json
import benchmark.reference.ops, benchmark.reference.trunk, benchmark.reference.optim
import benchmark.reference.world_model, benchmark.reference.tokenizer
print(json.dumps(sorted(sys.modules)))
'''
    out = run_python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split('.')[0] for m in loaded}
    assert not tops & {'dreamer4_torch', 'dreamer4_tpu', 'jax', 'jaxlib', 'flax', 'optax'}


def test_a_run_without_a_cuda_device_prints_no_result():
    if torch.cuda.is_available():
        return  # this check is for a machine without a card
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', 'wm_train_long',
                          '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
