"""The comparison that decides `correct`, at a tiny size on the CPU.

- The port, in float32 and on its plain path, agrees with the reference.
- The control (the reference in fp8, put in the program's place) is not
  correct.
- A run with each fault the cell can have planted under the timed path
  (`FAULTS` of the cell's entry) reports `correct` false: the whole run,
  set-up, window, check and report, past the look for a chip."""
from __future__ import annotations

import math

import pytest
import torch

from benchmark import harness, run

from .tiny import tiny_cell_config, tiny_workload

CELLS = ('wm_train_long', 'tok_train', 'wm_imagine')
CPU = torch.device('cpu')

# the port in float32 against the float32 reference: rounding, and Muon's
# Newton-Schulz iteration, which the port runs in bf16 whatever the model's
# precision (`train/optim.py` NS_DTYPE)
AGREE = {'loss_gap': 1e-4, 'flow_gap': 1e-3, 'grad_gap': 1e-4, 'change_gap': 0.05,
         'latent_err': 1e-4, 'logit_err': 1e-4, 'action_gap': 0.0}


def build(cell: str, seed: int = 11):
    wl = tiny_workload(cell)
    return harness.entry_module(wl['entry']).Cell(tiny_cell_config(cell), wl, seed, CPU), wl


@pytest.mark.parametrize('cell', CELLS)
def test_port_agrees_with_the_reference(cell):
    c, _ = build(cell)
    prog = c.program_readings()
    c.release_program()
    gaps = c.gaps(prog, c.reference_readings())
    for name, value in gaps.items():
        assert value <= AGREE[name], (name, value)


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    c, wl = build(cell)
    prog = c.program_readings()
    c.release_program()
    ref = c.reference_readings()
    gaps = c.gaps(c.control_readings(), ref)
    assert any(v > wl['limits'][k] for k, v in gaps.items()), gaps


def faults_of(cell):
    entry = harness.entry_module(tiny_workload(cell)['entry'])
    return [(cell, name) for name in entry.FAULTS]


@pytest.mark.parametrize('cell,fault', [cf for cell in CELLS for cf in faults_of(cell)])
def test_a_run_with_a_fault_is_not_correct(cell, fault):
    wl = tiny_workload(cell)
    entry = harness.entry_module(wl['entry'])
    with entry.FAULTS[fault]():
        result = run.run(cell, 23, 0.2, False, CPU, config=tiny_cell_config(cell), workload=wl)
    assert result['correct'] is False, result['check']
    assert list(result)[-1] == 'check'


@pytest.mark.parametrize('cell', CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(cell):
    wl = tiny_workload(cell)
    result = run.run(cell, 2 ** 31 + 5, 0.2, False, CPU, config=tiny_cell_config(cell),
                     workload=wl)
    assert result['correct'] is True, result['check']
    assert result['failed'] == 0 and result['attempted'] >= 1
    assert list(result) == ['correct', 'attempted', 'failed', 'metrics', 'device', 'check']
    man = harness.manifest()
    want = {m['name'] for m in run.cell_metrics(man, cell, 'end_to_end')}
    assert set(result['metrics']) == want
    assert all(math.isfinite(m['value']) and m['value'] > 0 for m in result['metrics'].values())
    for name, c in result['check'].items():
        assert c['limit'] == wl['limits'][name]


def test_a_traced_run_reports_per_layer_metrics():
    cell = 'wm_train_long'
    wl = tiny_workload(cell)
    result = run.run(cell, 3, 0.2, True, CPU, config=tiny_cell_config(cell), workload=wl)
    assert result['correct'] is True
    assert 'breakdown' in result and list(result)[-1] == 'check'
    assert {'busy_s', 'window_s'} <= set(result['device'])
    # the CPU trace has no kernel: the device metrics stay out
    assert 'idle_pct.train' not in result['metrics']
    assert 'mfu_pct.train' in result['metrics']
