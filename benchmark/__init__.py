"""The benchmark of `dreamer4_torch` on one H100: `python benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` from the root of a
checkout. See `harness.py` for what a run does."""
