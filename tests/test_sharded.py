"""Explicit-collectives sharded step vs the single-device step.

Runs on the 8-virtual-CPU-device mesh (conftest). The shard_map step with
row-sharded tables and data-sharded batches must produce the same parameters
and predictions as train/step.py on one device."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fwumious_wabbit_tpu.config.model_instance import (
    FeatureComboDesc,
    ModelInstance,
    Optimizer,
)
from fwumious_wabbit_tpu.config.vwmap import NamespaceDescriptor
from fwumious_wabbit_tpu.models.model import FwModel
from fwumious_wabbit_tpu.parallel import mesh as pmesh
from fwumious_wabbit_tpu.parallel.sharded import make_sharded_train_step
from fwumious_wabbit_tpu.train.step import make_train_step


def build_model(optimizer, nn=False, k=4, fields=3, bits=12):
    mi = ModelInstance()
    mi.optimizer = optimizer
    mi.learning_rate = 0.1
    mi.power_t = 0.5
    mi.ffm_learning_rate = 0.1
    mi.ffm_power_t = 0.5
    mi.nn_learning_rate = 0.1
    mi.nn_power_t = 0.5
    mi.bit_precision = bits
    mi.ffm_bit_precision = bits
    mi.ffm_k = k
    mi.init_acc_gradient = 0.0
    mi.ffm_init_acc_gradient = 0.0
    mi.nn_init_acc_gradient = 0.0
    descs = [NamespaceDescriptor(i) for i in range(fields)]
    mi.feature_combo_descs = [
        FeatureComboDesc(namespace_descriptors=[d]) for d in descs
    ]
    mi.ffm_fields = [[d] for d in descs]
    if nn:
        mi.nn_config.layers = [{"width": "8", "activation": "relu"}]
        mi.nn_config.topology = "one"
    return FwModel(mi)


def make_batch(model, B=32, L=6, N=6, seed=3):
    rng = np.random.default_rng(seed)
    mi = model.mi
    return {
        "label": rng.integers(0, 2, B).astype(np.float32),
        "importance": np.ones(B, np.float32),
        "lr_ids": (rng.integers(0, 1 << 30, (B, L)) & mi.lr_hash_mask).astype(np.int32),
        "lr_vals": np.ones((B, L), np.float32),
        "lr_combos": rng.integers(0, model.num_combos, (B, L)).astype(np.int32),
        "ffm_ids": (rng.integers(0, 1 << 30, (B, N)) & mi.ffm_hash_mask).astype(np.int32),
        "ffm_vals": np.ones((B, N), np.float32),
        "ffm_fields": rng.integers(0, model.num_fields, (B, N)).astype(np.int32),
    }


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
@pytest.mark.parametrize("opt,nn", [
    (Optimizer.ADAGRAD_FLEX, False),
    (Optimizer.ADAGRAD_LUT, False),
    (Optimizer.SGD, False),
    (Optimizer.ADAGRAD_LUT, True),
])
def test_sharded_step_matches_single_device(opt, nn, exchange):
    model = build_model(opt, nn=nn)
    batch = make_batch(model)

    # single-device reference trajectory
    ref_params = model.init_params()
    ref_step = make_train_step(model)
    ref1, ref_preds = ref_step(ref_params, batch)

    # 4 data x 2 table mesh
    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])
    params = model.init_params(mesh=mesh)
    sbatch = pmesh.shard_batch(batch, mesh, both_axes=(exchange == "a2a"))

    step = make_sharded_train_step(model, mesh, exchange=exchange)
    new_params, preds = step(params, sbatch)

    np.testing.assert_allclose(np.asarray(preds), np.asarray(ref_preds),
                               rtol=1e-6, atol=1e-7)
    for key in ("lr_w", "ffm_w"):
        got = np.asarray(new_params[key])
        want = np.asarray(ref1[key])
        np.testing.assert_allclose(got[: want.shape[0]], want, rtol=1e-5, atol=1e-7)
        # padded rows stay zero
        assert np.all(got[want.shape[0]:] == 0.0)
    if opt != Optimizer.SGD:
        np.testing.assert_allclose(
            np.asarray(new_params["lr_acc"])[: np.asarray(ref1["lr_acc"]).shape[0]],
            np.asarray(ref1["lr_acc"]), rtol=1e-5, atol=1e-7)
    if nn:
        for la, lb in zip(new_params["nn"], ref1["nn"]):
            np.testing.assert_allclose(np.asarray(la["w"]), np.asarray(lb["w"]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_sharded_multi_step_trajectory(exchange):
    model = build_model(Optimizer.ADAGRAD_LUT)
    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])
    params = model.init_params(mesh=mesh)
    ref_params = model.init_params()
    ref_step = make_train_step(model)
    step = make_sharded_train_step(model, mesh, exchange=exchange)
    both = exchange == "a2a"
    for s in range(4):
        batch = make_batch(model, seed=s)
        sbatch = pmesh.shard_batch(batch, mesh, both_axes=both)
        params, preds = step(params, sbatch)
        ref_params, ref_preds = ref_step(ref_params, batch)
        np.testing.assert_allclose(np.asarray(preds), np.asarray(ref_preds),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_sharded_step_applies_host_counts(exchange):
    """Batch-mean counts computed by the host over the GLOBAL batch ride
    the sharded batch and cap the gradients exactly as on one device. A
    weight shared by 37 examples has the soft-float code of 40 (rounded
    up), so the device's exact-count fallback would scale it differently:
    equality pins that the sharded step uses the host's counts."""
    from fwumious_wabbit_tpu.ops.adagrad import encode_counts
    from fwumious_wabbit_tpu.train.loop import host_count_keys

    model = build_model(Optimizer.ADAGRAD_LUT)
    model.mi.power_t = model.mi.ffm_power_t = 0.0
    model = FwModel(model.mi)  # batch-mean on for both scopes
    assert host_count_keys(model) == {"lr": 0, "ffm": 4}
    batch = make_batch(model, B=64)
    batch["lr_ids"][:37, 0] = 7  # one hot LR weight in 37 examples
    for key, shift in host_count_keys(model).items():
        ids = batch[f"{key}_ids"].astype(np.int64) >> shift
        _, inv, cnt = np.unique(ids, return_inverse=True, return_counts=True)
        batch[f"{key}_counts"] = encode_counts(cnt[inv].reshape(ids.shape))

    ref_new, ref_preds = make_train_step(model)(model.init_params(), batch)
    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])
    params = model.init_params(mesh=mesh)
    step = make_sharded_train_step(model, mesh, exchange=exchange,
                                   capacity_factor=8.0)
    new, preds = step(params, pmesh.shard_batch(batch, mesh,
                                                both_axes=exchange == "a2a"))
    np.testing.assert_allclose(np.asarray(preds), np.asarray(ref_preds),
                               rtol=1e-6, atol=1e-7)
    for key in ("lr_w", "lr_acc", "ffm_w", "ffm_acc"):
        want = np.asarray(ref_new[key])
        np.testing.assert_allclose(np.asarray(new[key])[: want.shape[0]], want,
                                   rtol=1e-5, atol=1e-7, err_msg=key)


def test_a2a_deep_table_axis():
    """a2a on a 1×8 mesh (pure table sharding) matches single device."""
    model = build_model(Optimizer.ADAGRAD_LUT)
    batch = make_batch(model, B=16)
    ref1, ref_preds = make_train_step(model)(model.init_params(), batch)
    mesh = pmesh.make_mesh(n_data=1, n_table=8, devices=jax.devices()[:8])
    params = model.init_params(mesh=mesh)
    sbatch = pmesh.shard_batch(batch, mesh, both_axes=True)
    # tiny per-device occupancy (K_dev = 12): raise the slack so binomial
    # bucket fluctuation cannot overflow (production K_dev/n_t ≫ 64 makes
    # the default 2× slack safe by Chernoff; tests are far below that)
    step = make_sharded_train_step(model, mesh, exchange="a2a",
                                   capacity_factor=8.0)
    new_params, preds = step(params, sbatch)
    np.testing.assert_allclose(np.asarray(preds), np.asarray(ref_preds),
                               rtol=1e-6, atol=1e-7)
    for key in ("lr_w", "ffm_w", "lr_acc", "ffm_acc"):
        got, want = np.asarray(new_params[key]), np.asarray(ref1[key])
        np.testing.assert_allclose(got[: want.shape[0]], want,
                                   rtol=1e-5, atol=1e-7)


def test_a2a_capacity_overflow_is_masked():
    """With a deliberately tiny capacity, overflowed occurrences must degrade
    gracefully (zero rows on lookup, dropped updates) — never NaN/garbage."""
    model = build_model(Optimizer.ADAGRAD_LUT)
    batch = make_batch(model, B=16)
    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])
    params = model.init_params(mesh=mesh)
    sbatch = pmesh.shard_batch(batch, mesh, both_axes=True)
    # capacity_factor 0.02 → capacity 1 slot per destination: heavy overflow
    step = make_sharded_train_step(model, mesh, exchange="a2a",
                                   capacity_factor=0.02)
    new_params, preds = step(params, sbatch)
    assert np.isfinite(np.asarray(preds)).all()
    assert (np.asarray(preds) > 0).all() and (np.asarray(preds) < 1).all()
    for key in ("lr_w", "ffm_w", "lr_acc", "ffm_acc"):
        assert np.isfinite(np.asarray(new_params[key])).all(), key


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_table_shards_replicated_across_data_axis(exchange):
    """check_vma=True cannot hold for this design: the table out_specs
    P('table', None) imply data-axis replication that the static vma checker
    cannot infer (jax 0.9 has no invariance-assertion primitive, and the
    replication here is by construction — update inputs are all_gather'd /
    a2a'd over 'data' so every data-replica applies identical updates).
    This test proves the replication at RUNTIME instead: after a step, the
    per-device shard bytes of every table must be identical across the data
    axis."""
    model = build_model(Optimizer.ADAGRAD_LUT)
    batch = make_batch(model, B=32)
    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])
    params = model.init_params(mesh=mesh)
    sbatch = pmesh.shard_batch(batch, mesh, both_axes=(exchange == "a2a"))
    step = make_sharded_train_step(model, mesh, exchange=exchange)
    new_params, _ = step(params, sbatch)
    for key in ("lr_w", "lr_acc", "ffm_w", "ffm_acc"):
        by_row = {}  # table row-range → {device data-coord: bytes}
        for shard in new_params[key].addressable_shards:
            rows = shard.index[0]
            by_row.setdefault((rows.start, rows.stop), []).append(
                np.asarray(shard.data).tobytes()
            )
        for rng, blobs in by_row.items():
            assert len(blobs) == 4, (key, rng)
            assert all(b == blobs[0] for b in blobs[1:]), (
                f"{key} rows {rng} diverged across data replicas")


def _collective_recv_bytes(txt: str) -> int:
    """Sum output bytes of all-to-all / all-gather / all-reduce instructions
    in compiled HLO — a per-device proxy for collective traffic."""
    import re

    total = 0
    for line in txt.splitlines():
        m = re.match(r"\s*%\S+ = (.*?)\s*(all-to-all|all-gather|all-reduce)\(",
                     line)
        if not m:
            continue
        for dims in re.findall(r"\w+\[([0-9,]*)\]", m.group(1)):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * 4
    return total


def test_a2a_comm_volume_shrinks_with_table_axis():
    """The point of the a2a exchange: per-shard collective bytes must SHRINK
    as the table axis grows (VERDICT r1: the psum/all_gather scheme's grew).
    Measured from the compiled HLO, not the analytical model; the analytical
    model (estimate_comm_bytes) must agree on the direction."""
    from fwumious_wabbit_tpu.parallel.sharded import estimate_comm_bytes

    def measured(nd, nt, exchange):
        model = build_model(Optimizer.ADAGRAD_LUT)
        batch = make_batch(model, B=64)
        mesh = pmesh.make_mesh(n_data=nd, n_table=nt, devices=jax.devices()[:8])
        params = model.init_params(mesh=mesh)
        sbatch = pmesh.shard_batch(batch, mesh, both_axes=(exchange == "a2a"))
        step = make_sharded_train_step(model, mesh, exchange=exchange)
        txt = step.lower(params, sbatch).compile().as_text()
        return _collective_recv_bytes(txt)

    a2a_2, a2a_4 = measured(4, 2, "a2a"), measured(2, 4, "a2a")
    psum_2, psum_4 = measured(4, 2, "psum"), measured(2, 4, "psum")
    # a2a per-shard traffic shrinks with n_table…
    assert a2a_4 < a2a_2, (a2a_2, a2a_4)
    # …the psum path's stays ~flat on a fixed device budget (its update
    # all_gather is ∝ n_data−1, its lookup psum ∝ n_table — no shrinkage)
    assert psum_4 >= psum_2 * 0.9, (psum_2, psum_4)
    # and at n_table=4 the a2a exchange moves less than psum
    assert a2a_4 < psum_4, (a2a_4, psum_4)
    # analytical model at fixed n_data and fixed global batch (growing the
    # machine by adding table shards): a2a per-shard traffic shrinks,
    # psum's grows
    est = lambda nt, ex: sum(  # noqa: E731
        estimate_comm_bytes(256, w, (4, nt), ex) for w in (6, 6)
    )
    assert est(8, "a2a") < est(4, "a2a") < est(2, "a2a")
    assert est(8, "psum") > est(2, "psum")


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_multi_row_slabs_sharded(exchange):
    """FFM slabs wider than one row (F·k > 128 → rows_per_slab > 1): the
    sharded gathers/updates move multiple consecutive rows per lookup and
    must still match the single-device trajectory."""
    model = build_model(Optimizer.ADAGRAD_LUT, k=64, fields=3, bits=16)
    assert model.ffm_spec.rows_per_slab > 1  # 3·64 = 192 → 2 rows/slab
    batch = make_batch(model, B=16)
    ref1, ref_preds = make_train_step(model)(model.init_params(), batch)

    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])
    params = model.init_params(mesh=mesh)
    sbatch = pmesh.shard_batch(batch, mesh, both_axes=(exchange == "a2a"))
    step = make_sharded_train_step(model, mesh, exchange=exchange,
                                   capacity_factor=8.0)
    new_params, preds = step(params, sbatch)
    np.testing.assert_allclose(np.asarray(preds), np.asarray(ref_preds),
                               rtol=1e-6, atol=1e-7)
    for key in ("lr_w", "ffm_w", "ffm_acc"):
        got, want = np.asarray(new_params[key]), np.asarray(ref1[key])
        np.testing.assert_allclose(got[: want.shape[0]], want,
                                   rtol=1e-5, atol=1e-7)


def test_a2a_overflow_counter_fires_and_is_zero_at_slack():
    """with_stats=True surfaces the per-step dropped-occurrence count:
    a deliberately undersized --fwt_a2a_capacity must report drops > 0,
    and a healthy 8x slack must report exactly zero (the observability
    demanded for the silent a2a overflow)."""
    model = build_model(Optimizer.ADAGRAD_LUT)
    batch = make_batch(model, B=16)
    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])

    def run(capacity_factor):
        params = model.init_params(mesh=mesh)
        sbatch = pmesh.shard_batch(batch, mesh, both_axes=True)
        step = make_sharded_train_step(model, mesh, exchange="a2a",
                                       capacity_factor=capacity_factor,
                                       with_stats=True)
        _params, preds, stats = step(params, sbatch)
        assert np.isfinite(np.asarray(preds)).all()
        return int(stats["a2a_dropped"])

    assert run(0.02) > 0      # capacity 1 slot/destination: heavy overflow
    assert run(8.0) == 0      # comfortable slack: nothing dropped


def test_a2a_overflow_counter_via_cli_loop(tmp_path):
    """End-to-end: run_train_loop reports a2a_dropped == 0 on a healthy
    capacity (and the result dict carries the counter)."""
    from fwumious_wabbit_tpu.config.cmdline import build_parser
    from fwumious_wabbit_tpu.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu.models.model import FwModel
    from fwumious_wabbit_tpu.train.loop import run_train_loop

    (tmp_path / "vw_namespace_map.csv").write_text("A,a\nB,b\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(
        f"{1 if i % 2 else -1} |A a{i % 7} |B b{i % 5}\n" for i in range(64)
    ))
    argv = ["--data", str(data), "--keep", "A", "--keep", "B",
            "-b", "18", "--adaptive", "-l", "0.1", "--fwt_platform", "cpu",
            "--fwt_batch_size", "16", "--fwt_data_axis", "4",
            "--fwt_table_axis", "2", "--fwt_exchange", "a2a",
            "--fwt_a2a_capacity", "8.0"]
    args = build_parser().parse_args(argv)
    vw = VwNamespaceMap.from_dataset_dir(args.data)
    mi = ModelInstance.from_cmdline(args, vw)
    model = FwModel(mi)
    result = run_train_loop(args, mi, vw, model)
    assert result["examples"] == 64
    assert result["a2a_dropped"] == 0


@pytest.mark.parametrize("bits,n_data,n_table", [
    (12, 4, 2), (12, 2, 4), (12, 1, 8), (7, 4, 2),
], ids=["4x2", "2x4", "1x8", "padded_rows"])
def test_init_params_on_mesh_builds_shards(bits, n_data, n_table):
    """Tables are born row-sharded over the table axis: each device holds
    1/n_table of every table's rows, and the values are the plain init's
    (rows added to reach a multiple of n_table read zero weights)."""
    model = build_model(Optimizer.ADAGRAD_LUT, nn=True, bits=bits)
    mesh = pmesh.make_mesh(n_data=n_data, n_table=n_table,
                           devices=jax.devices()[: n_data * n_table])
    plain = model.init_params()
    params = model.init_params(mesh=mesh)
    for key in ("lr_w", "lr_acc", "ffm_w", "ffm_acc"):
        arr, want = params[key], np.asarray(plain[key])
        rows = pmesh.table_rows(want.shape[0], mesh)
        assert arr.shape == (rows, want.shape[1])
        assert arr.sharding.spec == jax.sharding.PartitionSpec(pmesh.TABLE_AXIS, None)
        shards = arr.addressable_shards
        assert {s.device for s in shards} == set(mesh.devices.flat)
        assert all(s.data.shape[0] == rows // n_table for s in shards)
        got = np.asarray(arr)
        np.testing.assert_array_equal(got[: want.shape[0]], want)
        if key.endswith("_w"):
            assert np.all(got[want.shape[0]:] == 0.0)
    for la, lb in zip(params["nn"], plain["nn"]):
        assert la["w"].sharding.is_fully_replicated
        np.testing.assert_array_equal(np.asarray(la["w"]), np.asarray(lb["w"]))


@pytest.mark.parametrize("immutable", [False, True], ids=["resume", "immutable"])
def test_load_model_on_mesh_places_shards(tmp_path, immutable):
    """A model file loads straight into the mesh's shardings, equal to the
    plain load."""
    from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu.persistence import model_file

    model = build_model(Optimizer.ADAGRAD_LUT, bits=7)
    rng = np.random.default_rng(0)
    params = {k: (v + rng.random(v.shape, np.float32)
                  if k in ("lr_w", "ffm_w") else v)
              for k, v in model.init_params().items()}
    path = tmp_path / "m.fwt"
    vw = VwNamespaceMap.from_string("A,a\nB,b\nC,c\n")
    model_file.save_model(path, model.mi, vw, model, params)
    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])
    *_, plain = model_file.load_model(path, immutable=immutable)
    *_, sharded = model_file.load_model(path, immutable=immutable, mesh=mesh)
    assert set(sharded) == set(plain)
    for key in ("lr_w", "ffm_w") + (() if immutable else ("lr_acc", "ffm_acc")):
        want = np.asarray(plain[key])
        arr = sharded[key]
        assert arr.sharding.spec == jax.sharding.PartitionSpec(pmesh.TABLE_AXIS, None)
        assert arr.shape[0] == pmesh.table_rows(want.shape[0], mesh)
        np.testing.assert_array_equal(np.asarray(arr)[: want.shape[0]], want)
