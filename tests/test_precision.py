"""Every contraction in the device steps states its precision.

On the GPU a float32 contraction that names no precision may run in TF32
(~10 mantissa bits): a one-hot table select or a dedup sum would then
round every weight it touches, and the CPU tests could not see it. So the
jaxprs of the train, predict, packed and sharded steps are walked and every
``dot_general`` must carry HIGHEST — the selections and dedup sums always,
the model's own contractions under the CLI's default ``precision="highest"``.
"""

import numpy as np
import pytest

import jax
from jax.extend import core as jex_core

from fwumious_wabbit_tpu.config.model_instance import (
    FeatureComboDesc,
    ModelInstance,
    Optimizer,
)
from fwumious_wabbit_tpu.config.vwmap import NamespaceDescriptor
from fwumious_wabbit_tpu.models.model import FwModel
from fwumious_wabbit_tpu.ops.adagrad import encode_counts

HIGHEST = jax.lax.Precision.HIGHEST

# (ffm_k, fields, nn): LR only; FFM with several slabs per row
# (F·k = 8 → positions 16); FFM with slabs wider than a row (F·k = 144 →
# rows_per_slab 2); the ReLU tower over FFM
VARIANTS = {
    "lr_only": (0, 2, False),
    "ffm_positions": (4, 2, False),
    "ffm_multirow": (48, 3, False),
    "nn_tower": (4, 3, True),
}


def _model(ffm_k, fields, nn, precision="highest"):
    mi = ModelInstance()
    mi.optimizer = Optimizer.ADAGRAD_LUT
    mi.learning_rate = mi.ffm_learning_rate = mi.nn_learning_rate = 0.1
    mi.power_t = mi.ffm_power_t = 0.0  # batch-mean on, as in config 4
    mi.nn_power_t = 0.5
    mi.bit_precision = mi.ffm_bit_precision = 12
    mi.ffm_k = ffm_k
    mi.init_acc_gradient = mi.ffm_init_acc_gradient = 0.0
    descs = [NamespaceDescriptor(i) for i in range(fields)]
    mi.feature_combo_descs = [FeatureComboDesc(namespace_descriptors=[d])
                              for d in descs]
    mi.ffm_fields = [[d] for d in descs] if ffm_k else []
    if nn:
        mi.nn_config.layers = [{"width": "8", "activation": "relu"}]
        mi.nn_config.topology = "one"
    return FwModel(mi, precision=precision)


def _batch(model, B=16, L=4, N=4):
    rng = np.random.default_rng(0)
    mi = model.mi
    n = N if model.has_ffm else 0
    lr_ids = (rng.integers(0, 1 << 30, (B, L)) & mi.lr_hash_mask).astype(np.int32)
    ffm_ids = (rng.integers(0, 1 << 30, (B, n)) & mi.ffm_hash_mask).astype(np.int32)
    return {
        "label": rng.integers(0, 2, B).astype(np.float32),
        "importance": np.ones(B, np.float32),
        "lr_ids": lr_ids,
        "lr_vals": np.ones((B, L), np.float32),
        "lr_combos": rng.integers(0, model.num_combos, (B, L)).astype(np.int32),
        "lr_counts": encode_counts(np.ones((B, L))),
        "ffm_ids": ffm_ids,
        "ffm_vals": np.ones((B, n), np.float32),
        "ffm_fields": rng.integers(0, max(model.num_fields, 1), (B, n)).astype(np.int32),
        "ffm_counts": encode_counts(np.ones((B, n))),
    }


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a jaxpr, nested ones
    included (pjit, scan, custom_vjp, shard_map bodies)."""
    out = []

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    if isinstance(sub, jex_core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jex_core.Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return out


def _step_jaxpr(model, kind):
    batch = _batch(model)
    params = model.init_params()
    if kind == "train":
        from fwumious_wabbit_tpu.train.step import make_train_step

        return jax.make_jaxpr(make_train_step(model))(params, batch)
    if kind == "predict":
        from fwumious_wabbit_tpu.train.step import make_predict_step

        return jax.make_jaxpr(make_predict_step(model))(params, batch)
    if kind == "packed":
        from fwumious_wabbit_tpu.train import packed

        lay = packed.layout_of(batch)
        buf = packed.pack(lay, [batch, batch])
        return jax.make_jaxpr(packed.make_packed_train_step(model, lay, 2))(
            params, buf)
    from fwumious_wabbit_tpu.parallel import mesh as pmesh
    from fwumious_wabbit_tpu.parallel.sharded import make_sharded_train_step

    mesh = pmesh.make_mesh(n_data=2, n_table=2, devices=jax.devices()[:4])
    p = model.init_params(mesh=mesh)
    step = make_sharded_train_step(model, mesh, exchange="a2a",
                                   capacity_factor=4.0)
    return jax.make_jaxpr(step)(p, pmesh.shard_batch(batch, mesh, both_axes=True))


@pytest.mark.parametrize("kind", ["train", "predict", "packed", "sharded"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_every_contraction_is_highest(variant, kind):
    model = _model(*VARIANTS[variant])
    precs = _dot_precisions(_step_jaxpr(model, kind))
    assert precs, "the walk found no contraction at all"
    bad = [p for p in precs if p != (HIGHEST, HIGHEST)]
    assert not bad, f"{len(bad)} of {len(precs)} contractions: {bad[:4]}"


def test_default_precision_keeps_selections_exact():
    """Under precision='default' (TF32 on the GPU) only the model's own
    contractions relax: the table selections and dedup sums stay HIGHEST."""
    model = _model(4, 2, False, precision="default")
    precs = _dot_precisions(_step_jaxpr(model, "train"))
    exact = [p for p in precs if p == (HIGHEST, HIGHEST)]
    relaxed = [p for p in precs if p != (HIGHEST, HIGHEST)]
    assert exact and relaxed


@pytest.mark.parametrize("kind", ["train", "sharded"])
def test_chip_smoke_control_relaxes_every_contraction(kind):
    """chip_smoke.py's control step: with the selections at DEFAULT and a
    DEFAULT model, no contraction is left at HIGHEST, and the setting is
    restored afterwards."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    from fwumious_wabbit_tpu.ops import tables

    model = _model(4, 2, False, precision="default")
    with chip_smoke._selections_at(jax.lax.Precision.DEFAULT):
        precs = _dot_precisions(_step_jaxpr(model, kind))
    assert precs and HIGHEST not in {q for p in precs for q in p}
    assert tables.EXACT == HIGHEST
