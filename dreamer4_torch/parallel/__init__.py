"""Parallelism (counterpart of `dreamer4_tpu/parallel/`): the process group
and its (data, model) mesh (`distributed`, `mesh`), data-parallel batch
reductions and gradient averaging (`distributed`), and ring attention over
a mesh axis (`ring_attention`).

The counterpart is one SPMD program whose collectives XLA inserts. Here each
process runs eagerly on one device (a card, or the CPU with gloo) and the
collectives are explicit: a trainer given a mesh averages its gradients over
`data`, and the loss code reduces over the batch through
`distributed.batch_mean`, `batch_sum` and `batch_gather`, which inside
`distributed.batch_parallel` reduce over the ranks of `data`, so that every
rank computes the loss of the global batch.

The submodules are imported by name: `ring_attention` reads the attention
ops, and the attention reads `ring_attention`.
"""
