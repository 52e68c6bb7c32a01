"""Start-up rules: where the compile cache goes, that the CLI needs no
package beyond the guaranteed ones, and the benchmark's peak table."""

import argparse
import builtins
import os
import subprocess
import sys
from pathlib import Path

import pytest

from fwumious_wabbit_tpu.config.cmdline import build_parser
from fwumious_wabbit_tpu.utils import compile_cache as cc

ROOT = Path(__file__).resolve().parents[1]


def _args(*argv):
    return build_parser().parse_args(list(argv))


@pytest.fixture
def no_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    return monkeypatch


def test_env_dir_wins_over_flag_and_default(no_env, tmp_path):
    no_env.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert cc.compile_cache_dir(_args()) == str(tmp_path / "env")
    assert cc.compile_cache_dir(
        _args("--fwt_compile_cache", str(tmp_path / "flag"))) == str(tmp_path / "env")


def test_default_dir_is_fixed_inside_the_checkout(no_env, tmp_path):
    no_env.chdir(tmp_path)
    first = cc.compile_cache_dir(_args())
    no_env.chdir("/")
    assert cc.compile_cache_dir(_args()) == first == str(ROOT / ".jax_cache")


def test_cache_is_on_with_an_auto_platform(no_env):
    """JAX_PLATFORMS unset (the GPU machine's normal state) or a priority
    list led by the card: the default cache engages."""
    assert cc.compile_cache_dir(_args()) == cc.DEFAULT_DIR
    no_env.setenv("JAX_PLATFORMS", "cuda,cpu")
    assert cc.compile_cache_dir(_args()) == cc.DEFAULT_DIR


def test_cache_off_for_cpu_pinned_runs_and_off_flag(no_env, tmp_path):
    no_env.setenv("JAX_PLATFORMS", "cpu")
    assert cc.compile_cache_dir(_args()) is None
    assert cc.compile_cache_dir(
        _args("--fwt_compile_cache", str(tmp_path))) == str(tmp_path)
    no_env.delenv("JAX_PLATFORMS")
    assert cc.compile_cache_dir(_args("--fwt_compile_cache", "off")) is None
    assert cc.compile_cache_dir(_args("--fwt_platform", "cpu")) is None


@pytest.mark.parametrize("word", ["on", "true", "1", "ON"])
def test_switch_words_are_not_directories(word, capsys):
    with pytest.raises(SystemExit):
        _args("--fwt_compile_cache", word)
    assert "not a directory" in capsys.readouterr().err


def test_compile_cache_arg_accepts_directories():
    assert build_parser().parse_args(
        ["--fwt_compile_cache", "cache_dir"]).fwt_compile_cache == "cache_dir"
    with pytest.raises(argparse.ArgumentTypeError):
        from fwumious_wabbit_tpu.config.cmdline import compile_cache_arg

        compile_cache_arg("yes")


def test_cli_cache_roundtrip_without_zstandard(tmp_path):
    """The CLI imports and runs a -c round trip (writes the .fwcache, then
    reads it back) in a process where `import zstandard` fails."""
    (tmp_path / "vw_namespace_map.csv").write_text("A,a\nB,b\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(f"{1 if i % 3 else -1} |A a{i % 5} |B b{i % 7}\n"
                            for i in range(300)))
    code = f"""
import builtins, sys
real = builtins.__import__
def guard(name, *a, **k):
    if name.split('.')[0] == 'zstandard':
        raise ImportError('zstandard blocked')
    return real(name, *a, **k)
builtins.__import__ = guard
sys.modules.pop('zstandard', None)
from fwumious_wabbit_tpu.train.loop import main
common = ['--data', {str(data)!r}, '-c', '--keep', 'A', '--keep', 'B',
          '-b', '16', '--adaptive', '--fwt_batch_size', '32',
          '--fwt_platform', 'cpu', '--fwt_pack_cache', 'off']
assert main(common + ['-p', {str(tmp_path / 'p1')!r}]) == 0
assert main(common + ['-p', {str(tmp_path / 'p2')!r}]) == 0
assert 'zstandard' not in sys.modules
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "d.vw.fwcache").exists()
    assert "using cache file" in r.stderr
    p1 = (tmp_path / "p1").read_text()
    assert p1 == (tmp_path / "p2").read_text() and len(p1.splitlines()) == 300


def test_zst_input_without_zstandard_names_the_package(tmp_path, monkeypatch):
    from fwumious_wabbit_tpu.ingest.reader import create_buffered_input

    real = builtins.__import__

    def guard(name, *a, **k):
        if name.split(".")[0] == "zstandard":
            raise ImportError("blocked")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guard)
    (tmp_path / "d.vw.zst").write_bytes(b"")
    with pytest.raises(RuntimeError, match="zstandard"):
        create_buffered_input(tmp_path / "d.vw.zst")


def test_peak_table_knows_the_h100_and_refuses_unknown_kinds():
    import bench

    assert bench.peak_hbm_bytes_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert bench.peak_hbm_bytes_s("NVIDIA H100 PCIe") == 2.0e12
    with pytest.raises(ValueError, match="no published peak"):
        bench.peak_hbm_bytes_s("cpu")
