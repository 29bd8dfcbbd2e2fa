"""Run the port's recipes to their learning gates and record each run.

    python3 scripts/torch_recipe_gates.py [--seeds 0 1 2] [--recipes NAME ...]
        [--out gate_runs] [--device cuda]

Each recipe runs as `python -m dreamer4_torch.examples.<module>` in a
subprocess with its gate settings (below), from a seed; its output goes to
`<out>/<recipe>_seed<s>.log` and its last lines to standard output. The
first line printed is the card's `nvidia-smi --query-gpu=name,power.limit`
line (or the CPU's, with `--device cpu`); each run ends in one JSON line
with the recipe, the seed, the exit code, the wall seconds and the line
that states its result. A run that misses its gate at seed 0 is run again
at the next seeds given. Files go under `<out>/work`.
"""
from __future__ import annotations

import argparse
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

# recipe -> (module, flags; '{work}' is the run's work directory). The
# gate of each is its own exit code, and the line matched is its result.
GATES = {
    'snake_rl_collector': ('train_snake_rl_collector',
                           ['--max-iterations', '600', '--buffer', '{work}/buffer'],
                           ('GATE REACHED', 'gate NOT reached', 'collected')),
    'snake_ppo': ('train_snake_ppo', ['--buffer', '{work}/buffer'], ('collected',)),
    'reacher': ('train_reacher_proprio_dynamics',
                ['--steps', '300', '--data', '{work}/trajs'],
                ('forced-action dream divergence', 'PASS', 'WEAK')),
    'cartpole_online': ('train_cartpole_with_dynamics_rl', [],
                        ('SOLVED at iteration', 'did not reach')),
}
NO_MODEL = {'snake_ppo'}   # the scripted collector takes no --seed and no --device


def card_line(device: str) -> str:
    if device == 'cpu':
        return f'CPU: {platform.processor() or platform.machine()}'
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip()


def run_gate(recipe: str, seed: int, out: Path, device: str) -> dict:
    module, flags, markers = GATES[recipe]
    work = out / 'work' / f'{recipe}_seed{seed}'
    work.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, '-u', '-m', f'dreamer4_torch.examples.{module}',
           *[f.format(work=work) for f in flags]]
    if recipe not in NO_MODEL:
        cmd += ['--seed', str(seed), '--device', device]
    log_path = out / f'{recipe}_seed{seed}.log'
    t0 = time.perf_counter()
    with open(log_path, 'w') as f:
        f.write(f'# python3 {" ".join(cmd[1:])}\n')
        f.flush()
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT).returncode
    wall = time.perf_counter() - t0
    lines = log_path.read_text().splitlines()
    result = [l for l in lines if any(m in l for m in markers)]
    with open(log_path, 'a') as f:
        f.write(f'# exit {rc}, wall {wall:.1f} s\n')
    print('\n'.join(lines[-6:]), flush=True)
    return dict(recipe=recipe, seed=seed, rc=rc, wall_s=round(wall, 1), result=result)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--recipes', nargs='+', default=['snake_ppo', 'reacher',
                                                    'snake_rl_collector'],
                   choices=sorted(GATES))
    p.add_argument('--seeds', nargs='+', type=int, default=[0, 1, 2])
    p.add_argument('--out', type=str, default='gate_runs')
    p.add_argument('--device', type=str, default='cuda')
    args = p.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(card_line(args.device), flush=True)
    records = []
    for recipe in args.recipes:
        seeds = [0] if recipe in NO_MODEL else args.seeds
        for seed in seeds:
            record = run_gate(recipe, seed, out, args.device)
            records.append(record)
            print(json.dumps(record), flush=True)
            if record['rc'] == 0:
                break
    (out / 'gates.json').write_text(json.dumps(records, indent=1))
    last_rc = {r['recipe']: r['rc'] for r in records}   # each recipe's last seed
    return 0 if all(rc == 0 for rc in last_rc.values()) else 1


if __name__ == '__main__':
    sys.exit(main())
