"""BENCHMARK.json and the files it names: the contract's shapes, names and
limits, and that every cell, configuration, metric and entry has its file."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'
MAN = json.loads((ROOT / 'BENCHMARK.json').read_text())

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_.\-/]{1,200}$')
ONE_LINE = re.compile(r'^[^\n\t]{1,200}$')
WIDTH_WORDS = ('hidden', 'intermediate', 'latent', 'state', 'projection', 'head', 'expansion',
               'experts_per_tok', 'num_experts_per_tok')


def test_top_level_keys():
    assert set(MAN) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                        'end_to_end', 'per_layer'}
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MAN['paths']) <= 16
    for p in MAN['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p.split('/')
        assert (ROOT / p).is_dir()
    assert 1 <= len(MAN['command']) <= 32
    for word in MAN['command']:
        assert ONE_LINE.match(word) and not word.startswith('/') and '..' not in word
        if '/' in word:
            assert any(word.startswith(p + '/') for p in MAN['paths'])


def test_run_seconds_fit_the_check_with_24_cells():
    s = MAN['run_seconds']
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_uniqueness():
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in MAN[group]]
        assert len(names) == len(set(names)), group
        for name in names:
            assert NAME.match(name), name
    metrics = MAN['end_to_end'] + MAN['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')


def test_configs():
    assert 1 <= len(MAN['configs']) <= 24
    used = {w['config'] for w in MAN['workloads']}
    files = [c['file'] for c in MAN['configs']]
    assert len(files) == len(set(files))
    for c in MAN['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['name'] in used
        assert ONE_LINE.match(c['source']) and ONE_LINE.match(c['why'])
        assert any(c['file'].startswith(p + '/') for p in MAN['paths'])
        data = json.loads((ROOT / c['file']).read_text())
        assert data['name'] == c['name']
        assert data['reduced'] == c['reduced'] and len(c['reduced']) <= 16
        for key in c['reduced']:
            assert NAME.match(key)
            assert not key.endswith(('_dim', '_rank')) and not any(w in key for w in WIDTH_WORDS)


def test_cells():
    ws = MAN['workloads']
    assert 1 <= len(ws) <= 24
    pairs = [(w['config'], w['traffic']) for w in ws]
    assert len(pairs) == len(set(pairs))
    configs = {c['name'] for c in MAN['configs']}
    assert sum(w['chips'] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and w['config'] in configs
        assert NAME.match(w['traffic']) and ONE_LINE.match(w['why'])
        traffic = json.loads((BENCH / 'workloads' / f"{w['traffic']}.json").read_text())
        assert traffic['config'] == w['config']
        assert (BENCH / 'entries' / f"{traffic['entry']}.py").is_file()


def test_end_to_end_metrics():
    e2e = MAN['end_to_end']
    assert 1 <= len(e2e) <= 16
    assert any(m['name'] == 'setup_s' for m in e2e)
    cells = {w['name'] for w in MAN['workloads']}
    for m in e2e:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        assert set(m.get('workloads', cells)) <= cells
        assert (BENCH / 'metrics' / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = [m['name'] for m in e2e if cell in m.get('workloads', cells)]
        assert 'setup_s' in reported and len(reported) >= 2, cell


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m['name']: m for m in MAN['end_to_end']}
    cells = {w['name'] for w in MAN['workloads']}
    assert 1 <= len(MAN['per_layer']) <= 128
    for m in MAN['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        assert ONE_LINE.match(m['layer'])
        assert m['moves'] in e2e and m['moves'] != 'setup_s'
        moved = e2e[m['moves']]
        for cell in m['workloads']:
            assert cell in cells
            assert cell in moved.get('workloads', cells), (m['name'], cell)
        assert (BENCH / 'metrics' / f"{m['name']}.py").is_file()
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for cell in cells:
        assert any(cell in m['workloads'] for m in MAN['per_layer']), cell


@pytest.mark.parametrize('cell', [w['name'] for w in MAN['workloads']])
def test_every_compared_number_has_a_limit(cell):
    traffic = json.loads((BENCH / 'workloads' / f'{cell}.json').read_text())
    limits = traffic['limits']
    # an exact comparison has the limit 0
    assert limits and all(isinstance(v, float) and v >= 0 for v in limits.values())


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH.rglob('*'):
        if '__pycache__' in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r'^[A-Za-z0-9_.\-/]+$', rel), rel
