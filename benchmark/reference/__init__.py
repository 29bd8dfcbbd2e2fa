"""The plain reference the benchmark holds the port against.

Plain PyTorch in float32 (TF32 off), written from the published model
equations over a flat dict of weights that the benchmark makes itself. It
imports nothing of the port and nothing of the JAX package. `Precision('fp8')`
computes every matrix product of the same code in float8: the control that has
to come out as not correct.
"""
