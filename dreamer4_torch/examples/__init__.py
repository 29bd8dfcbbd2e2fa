"""The port's recipes: counterparts of the ten scripts in `examples/`, with
the same file names, flags and defaults, log lines and exit codes.

    python -m dreamer4_torch.examples.<name> [flags] [--device cpu]

Each runs its models on `--device` (the card unless 'cpu' is asked for)
and steps its environment on the host. Each `main(argv)` parses its flags,
builds its environment and calls the recipe's function (`train`, or one
function per phase), which tests and `chip_smoke.py` also call directly.
The JAX recipes derive their random streams from `jax.random` keys; here
each stream is a `torch.Generator` of its own, seeded from `--seed` along
the same path (`common.stream`), so a gate may be reached at another
iteration than in JAX. Each module's docstring gives its mapping.
"""
