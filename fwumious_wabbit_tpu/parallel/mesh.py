"""Device mesh + shardings — the distributed layer of the framework.

The reference is single-machine: its only parallelism is hogwild
shared-memory data parallelism (reference: src/hogwild.rs:24-104) and a
serving thread pool. Here those capabilities map to (SURVEY.md §2.4):

* **data axis** — synchronous large-batch data parallelism replaces hogwild:
  the batch dimension of every input array is sharded over ``data``;
  gradients for dense (NN) parameters meet in ``psum`` (inserted by XLA from
  the sharding annotations).
* **table axis** — the hashed weight tables (LR ``2^b``, FFM
  ``2^ffm_bit + F·k``) are **row-sharded** over ``table``; lookups of
  replicated-id batches lower to local masked gathers + cross-shard
  reduction, and scatter-updates keep each row's update on its owner shard
  (GSPMD inserts the collectives — the explicit all-to-all id-exchange
  kernel is the optimized path for very large tables).

Tables have a multiple of the table-axis size as their row count, so
shards are equal, and are built or loaded already sharded.
The mesh is a plain reshape of the device list: the cards of one host are
joined all to all (NVLink), so no axis order is preferred, and XLA hands
the collectives to NCCL.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TABLE_AXIS = "table"


def make_mesh(n_data: int | None = None, n_table: int = 1, devices=None) -> Mesh:
    """Create a ('data', 'table') mesh. Defaults to all devices on data."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_data is None:
        n_data = n_dev // n_table
    if n_data * n_table != n_dev:
        raise ValueError(
            f"mesh {n_data}x{n_table} does not cover {n_dev} devices"
        )
    dev_array = np.asarray(devices).reshape(n_data, n_table)
    return Mesh(dev_array, (DATA_AXIS, TABLE_AXIS))


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def param_sharding(mesh: Mesh, params: dict) -> dict:
    """PartitionSpecs per parameter: tables row-sharded, dense replicated."""

    def spec_for(key, leaf):
        if key in ("lr_w", "lr_acc", "ffm_w", "ffm_acc"):
            # row tables [R, 128]: shard rows, lanes stay whole
            return NamedSharding(mesh, P(TABLE_AXIS, None))
        return NamedSharding(mesh, P())  # NN params replicated

    out = {}
    for k, v in params.items():
        if k == "nn":
            out[k] = [
                {kk: NamedSharding(mesh, P()) for kk in layer} for layer in v
            ]
        elif isinstance(v, dict):
            out[k] = {kk: NamedSharding(mesh, P()) for kk in v}
        else:
            out[k] = spec_for(k, v)
    return out


def batch_sharding(mesh: Mesh, batch: dict, both_axes: bool = False) -> dict:
    """Batch arrays shard on axis 0 — over ``data`` (psum exchange) or over
    ``('data','table')`` (a2a exchange: every device owns distinct
    examples)."""
    axes = (DATA_AXIS, TABLE_AXIS) if both_axes else DATA_AXIS
    return {k: NamedSharding(mesh, P(axes)) for k in batch}


def mesh_from_args(args) -> Mesh | None:
    """The run's mesh from ``--fwt_data_axis`` / ``--fwt_table_axis``, or
    None for a single-device run."""
    n_table = int(getattr(args, "fwt_table_axis", 1) or 1)
    n_data = getattr(args, "fwt_data_axis", None)
    if n_table == 1 and (n_data is None or int(n_data) <= 1):
        return None
    return make_mesh(n_data=int(n_data) if n_data is not None else None,
                     n_table=n_table)


def table_rows(rows: int, mesh: Mesh | None) -> int:
    """Row count of a table on ``mesh``: a multiple of the table-axis size,
    so that shards are equal (rows beyond the hash range are never
    addressed — masked hashes are < 2^bits)."""
    return rows if mesh is None else round_up(rows, mesh.shape[TABLE_AXIS])


def shard_params(params: dict, shardings: dict):
    """Place ``params`` (host or device arrays) with ``shardings``: a host
    array goes to each device as that device's shard only."""
    return jax.tree.map(
        lambda x, s: jax.device_put(x, s), params, shardings,
        is_leaf=lambda x: not isinstance(x, (dict, list)),
    )


def shard_batch(batch: dict, mesh: Mesh, both_axes: bool = False) -> dict:
    sh = batch_sharding(mesh, batch, both_axes)
    return {k: jax.device_put(v, sh[k]) for k, v in batch.items()}
