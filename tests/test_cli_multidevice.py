"""CLI-driven multi-device training: --fwt_table_axis / --fwt_data_axis must
run the sharded step and produce predictions equal to the single-device run
(on the conftest 8-virtual-CPU-device mesh)."""

import numpy as np
import pytest

from fwumious_wabbit_tpu.config.cmdline import build_parser
from fwumious_wabbit_tpu.config.model_instance import ModelInstance
from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu.models.model import FwModel
from fwumious_wabbit_tpu.train.loop import run_train_loop

VW_CSV = "A,animal\nB,food\n"


def write_dataset(tmp_path, rows=256):
    rng = np.random.default_rng(1)
    (tmp_path / "vw_namespace_map.csv").write_text(VW_CSV)
    data = tmp_path / "data.vw"
    with open(data, "w") as f:
        for _ in range(rows):
            a, b = rng.integers(0, 30), rng.integers(0, 30)
            label = 1 if (a * b) % 3 == 0 else -1
            f.write(f"{label} |A a{a} |B b{b}\n")
    return data


def run(tmp_path, data, extra, name):
    argv = ["--keep", "A", "--keep", "B", "--interactions", "AB",
            "--ffm_k", "4", "--ffm_field", "A", "--ffm_field", "B",
            "-b", "18", "--adaptive", "-l", "0.1", "--power_t", "0.5",
            "--data", str(data), "-p", str(tmp_path / name),
            "--fwt_batch_size", "64", *extra]
    args = build_parser().parse_args(argv)
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(args, vw)
    model = FwModel(mi)
    result = run_train_loop(args, mi, vw, model)
    return (tmp_path / name).read_text(), result


@pytest.mark.parametrize("extra", [
    ["--fwt_table_axis", "2"],                               # auto → a2a
    ["--fwt_data_axis", "4", "--fwt_table_axis", "2"],       # auto → a2a
    ["--fwt_data_axis", "4", "--fwt_table_axis", "2",
     "--fwt_exchange", "psum"],
    ["--fwt_table_axis", "2", "--fwt_exchange", "a2a",
     "--fwt_a2a_capacity", "8.0"],
    ["--fwt_data_axis", "8"],
], ids=["table2", "data4xtable2", "psum", "a2a_explicit", "data8"])
def test_cli_mesh_matches_single_device(tmp_path, extra):
    data = write_dataset(tmp_path)
    single, _ = run(tmp_path, data, [], "single.out")
    multi, _ = run(tmp_path, data, extra, "multi.out")
    s = np.array([float(x) for x in single.splitlines()])
    m = np.array([float(x) for x in multi.splitlines()])
    np.testing.assert_allclose(m, s, rtol=1e-5, atol=1e-6)


def test_cli_mesh_save_load_roundtrip(tmp_path):
    """Sharded-run params save to the same flat model file layout (gathered
    and de-padded) and are numerically the plain run's weights."""
    from fwumious_wabbit_tpu.persistence import model_file

    data = write_dataset(tmp_path)
    argvs = {
        "sharded": ["--fwt_table_axis", "2"],
        "plain": [],
    }
    saved = {}
    for tag, extra in argvs.items():
        argv = ["--keep", "A", "--keep", "B", "--ffm_k", "4",
                "--ffm_field", "A", "--ffm_field", "B", "-b", "16",
                "--adaptive", "-l", "0.1", "--data", str(data),
                "--fwt_batch_size", "64", *extra]
        args = build_parser().parse_args(argv)
        vw = VwNamespaceMap.from_dataset_dir(str(data))
        mi = ModelInstance.from_cmdline(args, vw)
        model = FwModel(mi)
        result = run_train_loop(args, mi, vw, model)
        path = tmp_path / f"{tag}.fwt"
        model_file.save_model(path, mi, vw, model, result["params"])
        saved[tag] = path
    # same size (padding stripped) and numerically equal weights
    a = np.frombuffer(saved["sharded"].read_bytes()[-4096:], np.uint8)
    b = np.frombuffer(saved["plain"].read_bytes()[-4096:], np.uint8)
    assert saved["sharded"].stat().st_size == saved["plain"].stat().st_size
    mi_a, _, _, pa = model_file.load_model(saved["sharded"])
    mi_b, _, _, pb = model_file.load_model(saved["plain"])
    np.testing.assert_allclose(np.asarray(pa["lr_w"]), np.asarray(pb["lr_w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pa["ffm_w"]), np.asarray(pb["ffm_w"]),
                               rtol=1e-5, atol=1e-6)


def test_cli_mesh_resumes_from_a_model_file(tmp_path):
    """``-i`` with a mesh: the loaded model goes to its shardings and the
    resumed run predicts what the single-device resumed run predicts."""
    from fwumious_wabbit_tpu.train.loop import main

    data = write_dataset(tmp_path)
    common = ["--keep", "A", "--keep", "B", "--ffm_k", "4", "--ffm_field",
              "A", "--ffm_field", "B", "-b", "16", "--adaptive", "-l", "0.1",
              "--data", str(data), "--fwt_batch_size", "64"]
    model = tmp_path / "m.fwt"
    assert main(common + ["-f", str(model), "--save_resume"]) == 0
    out = {}
    for tag, extra in {"plain": [], "mesh": ["--fwt_data_axis", "4",
                                              "--fwt_table_axis", "2"]}.items():
        pred = tmp_path / f"{tag}.out"
        assert main(common + ["-i", str(model), "-p", str(pred), *extra]) == 0
        out[tag] = np.array(pred.read_text().split(), np.float64)
    assert out["mesh"].shape == (256,)
    np.testing.assert_allclose(out["mesh"], out["plain"], rtol=1e-5, atol=1e-6)
