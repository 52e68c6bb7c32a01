"""chip_smoke.py: its phases at tiny widths on the CPU backend, and its
refusal to report anything without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

TINY = cs.Smoke(rows=20_000, heldout=600, batch=1024, lr_bits=18,
                ffm_bits=18, tower_rows=4096, serve_lines=40, four_rows=4096,
                check_learning=False)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from fwumious_wabbit_tpu import native

    if native.load() is None:
        pytest.skip("no native toolchain")
    work = tmp_path_factory.mktemp("smoke")
    data, held = cs.make_data(TINY, work)
    watch = cs.CompileWatch()
    model = cs.phase_train(TINY, work, data, watch, jax.devices()[0])
    return work, data, held, model, watch


def test_phase_train_two_passes(trained):
    work, data, _, model, watch = trained
    assert model.exists() and (Path(str(data) + ".fwpack")).exists()
    assert not (work / "m2.fwt").exists()  # the second pass's model is dropped
    assert watch.seconds >= 0.0


def test_phase_train_tower(trained):
    work, data, _, _, watch = trained
    assert cs.phase_train(TINY, work, data, watch, jax.devices()[0],
                          tower=True) is None
    assert (work / "tower_pass1.txt").exists()


@pytest.mark.parametrize("tower", [False, True], ids=["config4", "tower"])
def test_phase_compare(trained, tower):
    _, data, _, model, _ = trained
    cpu = jax.devices("cpu")
    diffs = cs.phase_compare(TINY, data, model, cpu[1], cpu[0], tower=tower)
    assert set(diffs) >= {"pred", "lr_w", "lr_acc", "ffm_w", "ffm_acc"}
    assert all(v <= cs.STEP_ATOL for v in diffs.values())


def test_phase_predict_and_serve(trained):
    work, _, held, model, _ = trained
    expected = cs.phase_predict(TINY, work, model, held)
    assert expected.shape == (TINY.heldout,)
    cs.phase_serve(TINY, model, held, expected)


def test_phase_four_on_virtual_devices(trained):
    work, data, _, _, _ = trained
    devices = jax.devices()
    cs.phase_four(TINY, work, data, devices, mesh=(len(devices) // 2, 2))


def test_compile_watch_names_cache_traffic():
    import logging

    watch = cs.CompileWatch()
    lg = logging.getLogger("jax._src.compiler")
    with watch:
        lg.debug("Persistent compilation cache hit for '%s' with key %r",
                 "jit_packed_steps", "k1")
        lg.debug("PERSISTENT COMPILATION CACHE MISS for '%s' with key %r",
                 "jit_train_step", "k2")
        lg.debug("PERSISTENT COMPILATION CACHE MISS for '%s' with key %r",
                 "jit_concatenate", "k3")
    assert watch.hits == ["jit_packed_steps"]
    assert watch.step_misses() == ["jit_train_step"]
    assert lg.level == logging.NOTSET and lg.propagate


def test_main_refuses_the_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_script_fails_without_a_gpu_or_the_repo(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert ("ModuleNotFoundError" if alone else "no GPU") in r.stderr


@pytest.mark.gpu
def test_phase_compare_on_the_card(trained, gpu_device):
    """The GPU step against the CPU step at tiny widths (the full-width
    comparison is chip_smoke.py's compare phase)."""
    _, data, _, model, _ = trained
    diffs = cs.phase_compare(TINY, data, model, gpu_device,
                             jax.devices("cpu")[0])
    assert np.isfinite(list(diffs.values())).all()
