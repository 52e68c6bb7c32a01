"""weight_patcher: format roundtrips, C++/Python interop, model-file patching
(reference: weight_patcher/src/main.rs:278-351 tests the same invariants)."""

import gzip
from pathlib import Path

import numpy as np
import pytest

from fwumious_wabbit_tpu.tools import weight_patcher as wp



@pytest.fixture
def native_patcher():
    """The C++ patcher, built here if needed; skips without zlib."""
    path = wp.native_binary()
    if path is None:
        pytest.skip("native patcher cannot be built (zlib headers missing)")
    return path


def test_python_roundtrip_identical():
    a = bytes(range(256)) * 10
    diff = wp.create_diff_bytes(a, a)
    assert diff == b""
    assert wp.recreate_bytes(a, diff) == a


def test_python_roundtrip_random():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 10000, dtype=np.uint8).tobytes()
    b = bytearray(a)
    for i in rng.integers(0, len(a), 500):
        b[i] = (b[i] + 1) % 256
    b = bytes(b)
    diff = wp.create_diff_bytes(a, b)
    assert wp.recreate_bytes(a, diff) == b


def test_first_byte_differs():
    # first mismatch at index 0 → varint delta 0
    a, b = b"xbc", b"ybc"
    diff = wp.create_diff_bytes(a, b)
    assert diff == b"\x00" + b"y"
    assert wp.recreate_bytes(a, diff) == b


def test_native_python_interop(tmp_path, native_patcher):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, 300000, dtype=np.uint8).tobytes()
    b = bytearray(a)
    for i in rng.integers(0, len(a), 4000):
        b[i] = (b[i] ^ 0x5A) & 0xFF
    b = bytes(b)
    pa, pb = tmp_path / "a", tmp_path / "b"
    pa.write_bytes(a)
    pb.write_bytes(b)

    # native create → python recreate
    wp.create_diff(pa, pb, tmp_path / "d1", use_native=True)
    wp.recreate(pa, tmp_path / "d1", tmp_path / "o1", use_native=False)
    assert (tmp_path / "o1").read_bytes() == b

    # python create → native recreate
    wp.create_diff(pa, pb, tmp_path / "d2", use_native=False)
    wp.recreate(pa, tmp_path / "d2", tmp_path / "o2", use_native=True)
    assert (tmp_path / "o2").read_bytes() == b

    # payloads identical after decompression (same format)
    assert gzip.decompress((tmp_path / "d1").read_bytes()) == gzip.decompress(
        (tmp_path / "d2").read_bytes()
    )


def test_patch_model_files(tmp_path, native_patcher):
    """The production use: ship a checkpoint as a diff against the previous."""
    from fwumious_wabbit_tpu.config.model_instance import ModelInstance, Optimizer
    from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu.models.model import FwModel
    from fwumious_wabbit_tpu.persistence import model_file
    from fwumious_wabbit_tpu.train.step import make_train_step

    import jax.numpy as jnp

    vw = VwNamespaceMap.from_string("A,animal\nB,food\n")
    mi = ModelInstance()
    mi.optimizer = Optimizer.ADAGRAD_FLEX
    mi.learning_rate = 0.1
    mi.power_t = 0.5
    mi.bit_precision = 12
    mi.ffm_k = 0
    model = FwModel(mi)
    params = model.init_params()
    step = make_train_step(model)
    batch = {
        "label": np.ones(4, np.float32),
        "importance": np.ones(4, np.float32),
        "lr_ids": np.arange(8, dtype=np.int32).reshape(4, 2),
        "lr_vals": np.ones((4, 2), np.float32),
        "lr_combos": np.zeros((4, 2), np.int32),
        "ffm_ids": np.zeros((4, 0), np.int32),
        "ffm_vals": np.zeros((4, 0), np.float32),
        "ffm_fields": np.zeros((4, 0), np.int32),
    }
    m1 = tmp_path / "m1.fwt"
    model_file.save_model(m1, mi, vw, model, params)
    params2, _ = step({k: jnp.asarray(v) for k, v in params.items()}, batch)
    m2 = tmp_path / "m2.fwt"
    model_file.save_model(m2, mi, vw, model, params2)

    wp.create_diff(m1, m2, tmp_path / "patch")
    wp.recreate(m1, tmp_path / "patch", tmp_path / "m2r.fwt")
    assert (tmp_path / "m2r.fwt").read_bytes() == m2.read_bytes()
    assert (tmp_path / "patch").stat().st_size < m2.stat().st_size / 4
