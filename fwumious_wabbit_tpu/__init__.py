"""fwumious_wabbit_tpu — an accelerator-native online CTR engine, run on
NVIDIA GPUs through JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``outbrain-inc/fwumious_wabbit`` (VW-compatible hashed logistic regression,
field-aware factorization machines with intra-field interactions, small dense
towers, AdaGrad with the lookup-table fast path), re-designed for a
batched accelerator:

* host ingest pipeline produces fixed-shape padded batches;
* all model math lives in one pjit-compiled train/predict step;
* sparse tables row-shard across a device mesh with all-to-all id exchange;
* hogwild-style throughput becomes synchronous large-batch data parallelism.
"""

__version__ = "0.1.0"
