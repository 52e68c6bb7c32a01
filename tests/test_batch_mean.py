"""--fwt_batch_mean: per-weight averaging of per-example gradients across a
batch (ops/adagrad.batch_mean_grads).

Why it exists: the reference's own benchmark config (--adaptive --power_t
0.0, reference BENCHMARK.md) has a CONSTANT AdaGrad rate — stable online
(B=1) but divergent when a batch sums c ≈ B contributions to a popular
weight. Averaging bounds every weight's per-step movement by one online
update's, at any batch size, and is identical at B=1.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fwumious_wabbit_tpu.config.model_instance import (
    FeatureComboDesc,
    ModelInstance,
    Optimizer,
)
from fwumious_wabbit_tpu.config.vwmap import NamespaceDescriptor
from fwumious_wabbit_tpu.models.model import FwModel
from fwumious_wabbit_tpu.ops import tables
from fwumious_wabbit_tpu.ops.adagrad import (
    OPT_ADAGRAD_LUT,
    ScopedOptimizer,
    batch_mean_grads,
)
from fwumious_wabbit_tpu.train.step import make_train_step


def test_batch_mean_grads_per_lane_oracle():
    """With cap=1 (pure mean): counts are per WEIGHT (lane), not per row —
    two examples touching different lanes of the same row must not halve
    each other."""
    rid = np.array([0, 0, 0, 1], np.int32)
    g = np.zeros((4, tables.LANE), np.float32)
    g[0, 3] = 1.0   # example contribution to (row0, lane3)
    g[1, 3] = 3.0   # second contribution to the SAME weight → c=2
    g[2, 7] = 5.0   # different lane of row0 → c=1
    g[3, 3] = 7.0   # different row → c=1
    out = np.asarray(batch_mean_grads(8, jnp.asarray(rid), jnp.asarray(g), 1.0))
    assert out[0, 3] == 0.5 and out[1, 3] == 1.5  # divided by 2
    assert out[2, 7] == 5.0                        # untouched
    assert out[3, 3] == 7.0
    # scatter-sum after averaging = mean per weight
    total = np.zeros((8, tables.LANE), np.float32)
    np.add.at(total, rid, out)
    assert total[0, 3] == 2.0  # (1+3)/2


def test_cap_leaves_cold_weights_untouched():
    """Default cap=8: weights with ≤8 contributing examples are bit-identical
    to the summed form (FFM latent learning depends on this — counts there
    are 2–7); hotter weights are scaled to cap/c."""
    rid = np.asarray(np.zeros(12, np.int32))
    g = np.zeros((12, tables.LANE), np.float32)
    g[:, 0] = 1.0   # c=12 on (row0, lane0) → scale 8/12
    g[:3, 1] = 2.0  # c=3 on lane1 → untouched
    out = np.asarray(batch_mean_grads(4, jnp.asarray(rid), jnp.asarray(g), 8.0))
    np.testing.assert_allclose(out[:, 0], 8.0 / 12.0, rtol=1e-6)
    np.testing.assert_allclose(out[:3, 1], 2.0, rtol=0)


def _model(power_t, mode, bits=12):
    mi = ModelInstance()
    mi.optimizer = Optimizer.ADAGRAD_LUT
    mi.learning_rate = 0.1
    mi.power_t = power_t
    mi.init_acc_gradient = 0.0
    mi.bit_precision = bits
    mi.ffm_k = 0
    mi.feature_combo_descs = [
        FeatureComboDesc(namespace_descriptors=[NamespaceDescriptor(0)])
    ]
    return FwModel(mi, batch_mean_mode=mode)


def _batch(ids, labels):
    B = len(ids)
    return {
        "label": np.asarray(labels, np.float32),
        "importance": np.ones(B, np.float32),
        "lr_ids": np.asarray(ids, np.int32).reshape(B, 1),
        "lr_vals": np.ones((B, 1), np.float32),
        "lr_combos": np.zeros((B, 1), np.int32),
        "ffm_ids": np.zeros((B, 0), np.int32),
        "ffm_vals": np.zeros((B, 0), np.float32),
        "ffm_fields": np.zeros((B, 0), np.int32),
    }


def test_identical_at_batch_size_one():
    """At B=1 every mode gives the same trajectory (c == 1 always)."""
    b = _batch([7], [1.0])
    preds = {}
    for mode in ("off", "on", "auto"):
        model = _model(0.0, mode)
        params = model.init_params()
        step = make_train_step(model)
        seq = []
        for _ in range(3):
            params, p = step(params, b)
            seq.append(float(p[0]))
        preds[mode] = seq
    assert preds["off"] == preds["on"] == preds["auto"]


def test_auto_resolution():
    assert _model(0.0, "auto").opt_lr.batch_mean is True
    assert _model(0.5, "auto").opt_lr.batch_mean is False
    assert _model(0.5, "on").opt_lr.batch_mean is True
    assert _model(0.0, "off").opt_lr.batch_mean is False
    # --sgd is the bit-parity mode: never auto-averaged
    mi = ModelInstance()
    mi.optimizer = Optimizer.SGD
    mi.power_t = 0.0
    mi.ffm_k = 0
    mi.feature_combo_descs = [
        FeatureComboDesc(namespace_descriptors=[NamespaceDescriptor(0)])
    ]
    assert FwModel(mi, batch_mean_mode="auto").opt_lr.batch_mean is False


def test_popular_weight_step_bounded():
    """power_t 0, one weight hit by all 256 examples of a batch: the summed
    form moves it by ≈ lr·256·0.5 = 12.8 (divergence territory); the capped
    form by cap online updates' worth = 0.1·8·0.5 = 0.4."""
    ids = [5] * 256
    labels = [1.0] * 256
    b = _batch(ids, labels)

    model = _model(0.0, "off")
    params = model.init_params()
    step = make_train_step(model)
    params, _ = step(params, b)
    w_sum = float(np.asarray(params["lr_w"]).ravel()[5])

    model = _model(0.0, "auto")
    params = model.init_params()
    step = make_train_step(model)
    params, _ = step(params, b)
    w_capped = float(np.asarray(params["lr_w"]).ravel()[5])

    assert abs(w_sum) > 1.0             # summed: a wild step
    assert abs(w_capped - 0.4) < 1e-5   # exactly lr·cap·g = 0.1·8·0.5


def test_dedup_then_mean():
    """Duplicates within one example are summed FIRST (dedup), then the
    across-example mean (cap=1) divides by the number of EXAMPLES, not
    occurrences."""
    opt = ScopedOptimizer(OPT_ADAGRAD_LUT, 0.1, 0.0, 0.0, batch_mean=True,
                          batch_cap=1.0)
    w = jnp.zeros((4, tables.LANE), jnp.float32)
    acc = jnp.zeros((4, tables.LANE), jnp.float32)
    # 2 examples, width 2: example 0 contributes twice to (1, lane 0)
    rid = jnp.asarray([1, 1, 1, 2], jnp.int32)
    g = np.zeros((4, tables.LANE), np.float32)
    g[0, 0] = 0.5
    g[1, 0] = 0.25
    g[2, 0] = 1.0
    g[3, 5] = 1.0
    rid_d, g_d = tables.dedup_rows(jnp.asarray(rid), jnp.asarray(g), batch=2)
    w1, _ = opt.apply_rows(w, acc, rid_d, g_d)
    # weight (1,0): examples contribute 0.75 (summed within ex0) and 1.0 →
    # mean 0.875 → w -= 0.1·0.875
    assert abs(float(w1[1, 0]) + 0.0875) < 1e-6, float(w1[1, 0])


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_sharded_matches_single_device_with_batch_mean(exchange):
    """The sharded steps compute the same per-weight counts as the
    single-device step (gathered/global batch), so trajectories match."""
    import jax

    from fwumious_wabbit_tpu.parallel import mesh as pmesh
    from fwumious_wabbit_tpu.parallel.sharded import make_sharded_train_step
    from tests.test_sharded import build_model, make_batch

    model = build_model(Optimizer.ADAGRAD_LUT)
    # force power_t 0 + batch_mean on all sparse scopes
    model.opt_lr.power_t = 0.0
    model.opt_ffm.power_t = 0.0
    model.opt_lr.batch_mean = True
    model.opt_ffm.batch_mean = True
    batch = make_batch(model, B=32)

    ref1, ref_preds = make_train_step(model)(model.init_params(), batch)

    mesh = pmesh.make_mesh(n_data=4, n_table=2, devices=jax.devices()[:8])
    params = model.init_params(mesh=mesh)
    sbatch = pmesh.shard_batch(batch, mesh, both_axes=(exchange == "a2a"))
    step = make_sharded_train_step(model, mesh, exchange=exchange)
    new_params, preds = step(params, sbatch)
    np.testing.assert_allclose(np.asarray(preds), np.asarray(ref_preds),
                               rtol=1e-6, atol=1e-7)
    for key in ("lr_w", "ffm_w", "lr_acc", "ffm_acc"):
        got, want = np.asarray(new_params[key]), np.asarray(ref1[key])
        np.testing.assert_allclose(got[: want.shape[0]], want,
                                   rtol=1e-5, atol=1e-7)


def test_batch_mean_grads_fuzz_vs_scatter_oracle():
    """The sort-based run-counting implementation (no table-sized count
    buffer — a scatter version would materialize 2 GB per step on a 2^29
    table) must equal the straightforward scatter-count semantics."""
    rng = np.random.default_rng(11)
    for trial in range(20):
        K = int(rng.integers(1, 80))
        R = int(rng.integers(2, 20))
        cap = float(rng.choice([1.0, 2.0, 8.0]))
        rid = rng.integers(0, R, K).astype(np.int32)
        g = rng.normal(size=(K, tables.LANE)).astype(np.float32)
        g[rng.random((K, tables.LANE)) < 0.5] = 0.0
        cnt = np.zeros((R, tables.LANE), np.float32)
        np.add.at(cnt, rid, (g != 0).astype(np.float32))
        c = np.maximum(cnt[rid], 1.0)
        want = g * np.minimum(1.0, cap / c)
        got = np.asarray(batch_mean_grads(R, jnp.asarray(rid),
                                          jnp.asarray(g), cap))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=f"trial {trial}")


def test_host_counts_match_device_counts(tmp_path):
    """The C++ fwn_batch_counts multiplicities must equal the device sort's
    per-weight run counts for a batch with no within-example duplicates and
    no zero gradients — the regime where host and device counting are
    defined to agree."""
    import numpy as np

    from fwumious_wabbit_tpu import native

    if native.load() is None:
        pytest.skip("no native toolchain")

    rng = np.random.default_rng(3)
    B, W, nrows = 64, 8, 32
    # per-example UNIQUE ids (host counts pre-dedup; keep the regimes equal)
    ids = np.stack([
        rng.choice(nrows * 128, W, replace=False).astype(np.int32)
        for _ in range(B)
    ])
    mark = np.zeros((B, W), np.int8)

    class NI:
        _lib = native.load()
        batch_counts = native.NativeIngest.batch_counts

    from fwumious_wabbit_tpu.ops.adagrad import decode_counts

    host = np.asarray(decode_counts(jnp.asarray(
        NI().batch_counts(ids, mark, 0)))).astype(np.int64)

    flat = ids.reshape(-1)
    from collections import Counter
    c = Counter(flat.tolist())
    expected = np.array([c[i] for i in flat]).reshape(B, W)
    # counts here are small (W=8 draws over 4096 keys) — codes are exact
    np.testing.assert_array_equal(host, expected)


def test_apply_rows_host_counts_equals_sort_path():
    """apply_rows with precomputed counts must equal the sort-based
    batch_mean path when counts match (unique ids per example, nonzero g)."""
    import numpy as np

    from fwumious_wabbit_tpu.ops import tables
    from fwumious_wabbit_tpu.ops.adagrad import OPT_ADAGRAD_LUT, ScopedOptimizer

    rng = np.random.default_rng(5)
    nrows, B, W = 64, 32, 4
    ids = np.stack([
        rng.choice(nrows * 128, W, replace=False).astype(np.int32)
        for _ in range(B)
    ])
    g = rng.normal(size=(B, W)).astype(np.float32)
    g[g == 0] = 0.5

    opt = ScopedOptimizer(OPT_ADAGRAD_LUT, 0.1, 0.0, 0.0, batch_mean=True)
    w0 = jnp.asarray(rng.normal(size=(nrows, 128)).astype(np.float32))
    acc0 = jnp.zeros((nrows, 128), jnp.float32)

    rid, grows = tables.expand_scalar_grads_dedup(jnp.asarray(ids), jnp.asarray(g))
    w_a, acc_a = opt.apply_rows(w0, acc0, rid, grows)

    from collections import Counter
    c = Counter(ids.reshape(-1).tolist())
    counts = jnp.asarray(
        np.array([c[i] for i in ids.reshape(-1)], np.uint16))
    w_b, acc_b = opt.apply_rows(w0, acc0, rid, grows, counts=counts)

    np.testing.assert_allclose(np.asarray(w_b), np.asarray(w_a), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(acc_b), np.asarray(acc_a), rtol=1e-6)


def test_count_code_roundtrip():
    """The u8 soft-float count encoding: exact to 15, rounded UP within
    12.5% above (the cap only gets more conservative), monotone."""
    import numpy as np

    from fwumious_wabbit_tpu import native
    from fwumious_wabbit_tpu.ops.adagrad import decode_counts

    if native.load() is None:
        pytest.skip("no native toolchain")

    class NI:
        _lib = native.load()
        batch_counts = native.NativeIngest.batch_counts

    ni = NI()
    for c in [1, 2, 7, 15, 16, 17, 100, 255, 256, 1000, 32768, 524288]:
        ids = np.zeros((1, c), np.int32)  # c entries of one key
        mark = np.zeros((1, c), np.int8)
        if c > 1 << 16:
            ids = np.zeros((c // 64, 64), np.int32)
            mark = np.zeros((c // 64, 64), np.int8)
        code = ni.batch_counts(ids, mark, 0)
        dec = float(np.asarray(decode_counts(jnp.asarray(code))).ravel()[0])
        assert dec >= c, (c, dec)           # rounded up, never down
        assert dec <= c * 1.125 + 1, (c, dec)


def test_batch_counts_exclude_zero_valued_features():
    """fwn_batch_counts must skip explicit zero-valued entries (zero
    gradient → not 'touched'), matching the Python-oracle np_counts and the
    device path (advisor r2 finding): both engines must count the same."""
    import numpy as np

    from fwumious_wabbit_tpu import native

    if native.load() is None:
        pytest.skip("no native toolchain")

    class NI:
        _lib = native.load()
        batch_counts = native.NativeIngest.batch_counts

    ids = np.array([[5, 5, 9], [5, 9, 9]], np.int32)
    mark = np.zeros((2, 3), np.int8)
    mark[1, 2] = -1  # padding
    vals = np.array([[1.0, 0.0, 2.0], [3.0, 1.0, 0.0]], np.float32)

    code = NI().batch_counts(ids, mark, 0, vals=vals)
    from fwumious_wabbit_tpu.ops.adagrad import decode_counts
    got = np.asarray(decode_counts(jnp.asarray(code)))
    # nonzero-valued occurrences: id 5 x2 ([0,0],[1,0]), id 9 x2 ([0,2],[1,1])
    # zero-valued/padding slots report 0 (decoded 0 -> max(c,1) in the cap)
    want = np.array([[2, 0, 2], [2, 2, 0]], np.float32)
    np.testing.assert_array_equal(got, want)

    # the Python-ingest oracle (train/loop.py np_counts) must agree
    from fwumious_wabbit_tpu.ops.adagrad import encode_counts
    keys = ids.astype(np.uint32)
    real = (vals != 0.0) & (mark >= 0)
    flat = keys.reshape(-1)
    c = np.zeros(flat.shape, np.int64)
    u, inv, cnt = np.unique(flat[real.reshape(-1)], return_inverse=True,
                            return_counts=True)
    c[real.reshape(-1)] = cnt[inv]
    np.testing.assert_array_equal(code, encode_counts(c).reshape(ids.shape))


def test_dedup_rows_key_restricted_merge():
    """dedup_rows(keys=...) must merge only equal-key entries: same-row
    different-key entries keep separate payloads so per-entry host counts
    stay aligned (advisor r2 finding on ffm windows / lr lanes)."""
    import numpy as np

    from fwumious_wabbit_tpu.ops import tables

    B, W = 2, 4
    # example 0: entries 0,1 share row 3 but have DIFFERENT keys; entries
    # 2,3 share row 5 with the SAME key
    rid = np.array([[3, 3, 5, 5], [7, 7, 7, 2]], np.int32)
    keys = np.array([[30, 31, 50, 50], [70, 70, 71, 20]], np.int32)
    g = np.zeros((B * W, 128), np.float32)
    g[:, 0] = [1, 2, 4, 8, 16, 32, 64, 128]

    rid_out, g_out = tables.dedup_rows(
        jnp.asarray(rid.reshape(-1)), jnp.asarray(g), B,
        keys=jnp.asarray(keys))
    rid_out = np.asarray(rid_out).reshape(B, W)
    lane0 = np.asarray(g_out)[:, 0].reshape(B, W)

    np.testing.assert_array_equal(rid_out, rid)  # order preserved
    # ex0: different keys on row 3 -> NOT merged; same key on row 5 -> merged
    np.testing.assert_array_equal(lane0[0], [1, 2, 12, 0])
    # ex1: keys 70,70 merge; 71 stays; 20 separate row
    np.testing.assert_array_equal(lane0[1], [48, 0, 64, 128])


def test_prescale_equals_postscale_cap():
    """r4 refactor: scaling the pre-expansion scalars by count_factor must
    apply the same cap as apply_rows' legacy post-dedup row scaling —
    exactly when a weight's multiplicity is <= cap (factor 1.0), and to
    float tolerance above it (the sum-then-scale vs scale-then-sum
    distributivity difference is ULP-level)."""
    import jax.numpy as jnp
    import numpy as np

    from fwumious_wabbit_tpu.ops.adagrad import (
        OPT_ADAGRAD_LUT, ScopedOptimizer, encode_counts,
    )
    from fwumious_wabbit_tpu.ops import tables

    rng = np.random.default_rng(7)
    rows, B, L = 64, 32, 6
    spec = ScopedOptimizer(OPT_ADAGRAD_LUT, learning_rate=0.1, power_t=0.0,
                           initial_acc_gradient=0.0, batch_mean=True,
                           batch_cap=2.0)
    ids = rng.integers(0, rows * 128, (B, L)).astype(np.int32)
    ids[:, 0] = 7  # one hot weight: multiplicity B >> cap
    g = rng.normal(size=(B, L)).astype(np.float32) * 0.1
    flat = ids.reshape(-1)
    c = np.zeros(B * L, np.int64)
    u, inv, cnt = np.unique(flat, return_inverse=True, return_counts=True)
    c[:] = cnt[inv]
    codes = encode_counts(c).reshape(B, L)
    w0 = rng.normal(size=(rows, 128)).astype(np.float32)
    acc0 = np.zeros((rows, 128), np.float32)

    # legacy: expand, dedup keyed by id, post-dedup counts scaling
    _, aux = tables.gather_scalars(jnp.asarray(w0), jnp.asarray(ids))
    rid, grows = tables.expand_scalar_grads(aux, jnp.asarray(g))
    rid, grows = tables.dedup_rows(rid, grows, B, keys=jnp.asarray(ids))
    w_a, acc_a = spec.apply_rows(jnp.asarray(w0), jnp.asarray(acc0),
                                 rid, grows,
                                 counts=jnp.asarray(codes.reshape(-1)))

    # new: pre-scale scalars, cheap pre-expansion dedup, pre_scaled=True
    g2 = jnp.asarray(g) * spec.count_factor(jnp.asarray(codes))
    rid2, grows2 = tables.expand_scalar_grads_dedup(jnp.asarray(ids), g2)
    w_b, acc_b = spec.apply_rows(jnp.asarray(w0), jnp.asarray(acc0),
                                 rid2, grows2, pre_scaled=True)

    np.testing.assert_allclose(np.asarray(w_a), np.asarray(w_b),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(acc_a), np.asarray(acc_b),
                               rtol=1e-5, atol=1e-6)
    # the capped hot weight really was capped: its movement is bounded by
    # cap online-updates' worth
    assert not np.array_equal(np.asarray(w_a), w0)
