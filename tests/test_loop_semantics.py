"""Driver-loop semantics: the native block stream must reproduce the Python
per-example path exactly — holdout boundaries, predictions_after filtering,
prediction_model_delay, testonly, cache reuse (reference: src/main.rs:200-270)."""

import numpy as np
import pytest

from fwumious_wabbit_tpu.config.cmdline import build_parser
from fwumious_wabbit_tpu.config.model_instance import ModelInstance
from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
from fwumious_wabbit_tpu.models.model import FwModel
from fwumious_wabbit_tpu.train.loop import run_train_loop
from fwumious_wabbit_tpu import native

VW_CSV = "A,animal\nB,food\n"


def write_dataset(tmp_path, rows=300, seed=0):
    rng = np.random.default_rng(seed)
    (tmp_path / "vw_namespace_map.csv").write_text(VW_CSV)
    data = tmp_path / "data.vw"
    with open(data, "w") as f:
        for _ in range(rows):
            a = rng.integers(0, 20)
            b = rng.integers(0, 20)
            label = 1 if (a + b) % 2 == 0 else -1
            f.write(f"{label} |A a{a} |B b{b}\n")
    return data


def run(tmp_path, data, extra, predictions_name):
    argv = ["--keep", "A", "--keep", "B", "--interactions", "AB", "-b", "20",
            "--adaptive", "-l", "0.1", "--power_t", "0.0",
            "--data", str(data), "-p", str(tmp_path / predictions_name),
            "--fwt_batch_size", "64", *extra]
    args = build_parser().parse_args(argv)
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(args, vw)
    model = FwModel(mi)
    run_train_loop(args, mi, vw, model)
    return (tmp_path / predictions_name).read_text()


@pytest.mark.skipif(native.load() is None, reason="no native toolchain")
@pytest.mark.parametrize(
    "extra",
    [
        [],
        ["--holdout_after", "150"],
        ["--holdout_after", "97"],
        ["--predictions_after", "55"],
        ["--testonly"],
        ["--prediction_model_delay", "100"],
        ["--holdout_after", "150", "--predictions_after", "10"],
    ],
    ids=["plain", "holdout", "holdout-mid-batch", "pred-after", "testonly",
         "delay", "holdout+pred-after"],
)
def test_native_stream_matches_python_path(tmp_path, extra):
    data = write_dataset(tmp_path)
    p_native = run(tmp_path, data, extra, "native.out")
    p_python = run(tmp_path, data, extra + ["--fwt_no_native"], "python.out")
    assert p_native == p_python
    assert len(p_native.splitlines()) > 0 or "--predictions_after" not in extra


@pytest.mark.skipif(native.load() is None, reason="no native toolchain")
def test_native_cache_roundtrip_matches(tmp_path):
    data = write_dataset(tmp_path)
    p1 = run(tmp_path, data, ["-c"], "first.out")
    assert (tmp_path / "data.vw.fwcache").exists()
    p2 = run(tmp_path, data, ["-c"], "second.out")  # reads the cache
    assert p1 == p2


@pytest.mark.skipif(native.load() is None, reason="no native toolchain")
def test_cache_with_holdout_matches_python(tmp_path):
    """Cache read path + holdout boundary cuts (block_cap over records)."""
    data = write_dataset(tmp_path)
    extra = ["-c", "--holdout_after", "97"]
    p1 = run(tmp_path, data, extra, "c1.out")           # builds cache
    p2 = run(tmp_path, data, extra, "c2.out")           # reads cache
    p3 = run(tmp_path, data, ["--holdout_after", "97", "--fwt_no_native"], "c3.out")
    assert p1 == p2 == p3


@pytest.mark.skipif(native.load() is None, reason="no native toolchain")
def test_empty_line_terminates_stream(tmp_path):
    data = write_dataset(tmp_path, rows=50)
    text = data.read_text()
    with open(data, "w") as f:
        f.write("".join(text.splitlines(keepends=True)[:30]))
        f.write("\n")  # empty line = EOF
        f.write("".join(text.splitlines(keepends=True)[30:]))
    out = run(tmp_path, data, [], "cut.out")
    assert len(out.splitlines()) == 30
    out_py = run(tmp_path, data, ["--fwt_no_native"], "cut_py.out")
    assert out == out_py


@pytest.mark.parametrize("native", [True, False])
def test_inband_command_in_training_file_aborts(tmp_path, native):
    """The reference ABORTS a training run on an in-band flush/hogwild_load
    line (src/main.rs:218-221 propagates the parser's command "error" and
    exits 1) — both ingest engines must match, and an aborted -c run must
    not publish a truncated cache."""
    from fwumious_wabbit_tpu.train.loop import main as cli_main

    (tmp_path / "vw_namespace_map.csv").write_text("A,a\nB,b\n")
    data = tmp_path / "d.vw"
    data.write_text("1 |A x |B y\nflush\n-1 |A z |B w\n")
    flags = ["--data", str(data), "--keep", "A", "--keep", "B", "-b", "18",
             "--adaptive", "-l", "0.1", "--fwt_platform", "cpu",
             "--fwt_batch_size", "8", "-c",
             "-p", str(tmp_path / "p.out")]
    if not native:
        flags.append("--fwt_no_native")
    rc = cli_main(flags)
    assert rc == 1
    # no truncated cache published (only the .writing temp may remain)
    assert not (tmp_path / "d.vw.fwcache").exists()


def test_predictions_stdout(tmp_path, capsys):
    """--predictions_stdout writes the same %.6f lines to stdout as -p
    writes to the file (reference: src/main.rs:260-269)."""
    from fwumious_wabbit_tpu.train.loop import main as cli_main

    (tmp_path / "vw_namespace_map.csv").write_text("A,a\nB,b\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(
        f"{1 if i % 2 else -1} |A a{i % 5} |B b{i % 3}\n" for i in range(32)
    ))
    rc = cli_main(["--data", str(data), "--keep", "A", "--keep", "B",
                   "-b", "18", "--adaptive", "-l", "0.1",
                   "--fwt_platform", "cpu", "--fwt_batch_size", "8",
                   "--predictions_stdout", "-p", str(tmp_path / "p.out")])
    assert rc == 0
    out = capsys.readouterr().out
    stdout_lines = [l for l in out.splitlines() if l and l[0].isdigit()]
    file_lines = (tmp_path / "p.out").read_text().splitlines()
    assert stdout_lines == file_lines
    assert len(file_lines) == 32
    assert all(len(l.split(".")[1]) == 6 for l in file_lines)


def test_quiet_suppresses_progress(tmp_path, caplog):
    """--quiet raises the root log level to WARNING so the per-pass progress
    line is suppressed (reference: src/main.rs quiet gate on progress
    output)."""
    import logging

    from fwumious_wabbit_tpu.train.loop import main as cli_main

    (tmp_path / "vw_namespace_map.csv").write_text("A,a\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(f"{1 if i % 2 else -1} |A a{i % 4}\n" for i in range(16)))
    common = ["--data", str(data), "--keep", "A", "-b", "16", "--adaptive",
              "--fwt_platform", "cpu", "--fwt_batch_size", "8"]

    root = logging.getLogger()
    before = root.level
    try:
        with caplog.at_level(logging.INFO):
            assert cli_main(common) == 0
        loud = [r for r in caplog.records if "Elapsed" in r.getMessage()]
        assert loud, "progress line expected without --quiet"

        caplog.clear()
        root.setLevel(before)
        assert cli_main(common + ["--quiet"]) == 0
        assert root.level == logging.WARNING
        silent = [r for r in caplog.records
                  if r.levelno < logging.WARNING and "Elapsed" in r.getMessage()]
        assert not silent
    finally:
        root.setLevel(before)


def test_build_cache_without_training_cli(tmp_path):
    """--build_cache_without_training writes the cache and does no training
    (reference: src/main.rs:50-94); a following -c run must consume the
    prebuilt cache byte-identically to a cold cached run."""
    from fwumious_wabbit_tpu.train.loop import main as cli_main

    (tmp_path / "vw_namespace_map.csv").write_text("A,a\nB,b\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(
        f"{1 if i % 2 else -1} |A a{i % 6} |B b{i % 4}\n" for i in range(48)
    ))
    common = ["--data", str(data), "--keep", "A", "--keep", "B",
              "-b", "18", "--adaptive", "-l", "0.1",
              "--fwt_platform", "cpu", "--fwt_batch_size", "16"]

    rc = cli_main(common + ["-c", "--build_cache_without_training"])
    assert rc == 0
    caches = list(tmp_path.glob("*.fwcache"))
    assert caches, "cache file expected next to the data"
    assert not list(tmp_path.glob("*.out"))

    # a cached run consumes it; result equals a no-cache run
    assert cli_main(common + ["-c", "-p", str(tmp_path / "cached.out")]) == 0
    assert cli_main(common + ["-p", str(tmp_path / "plain.out")]) == 0
    assert (tmp_path / "cached.out").read_text() == (tmp_path / "plain.out").read_text()


def test_fwt_exact_equals_batch_size_one(tmp_path):
    """--fwt_exact is sugar for the exact online (B=1) schedule — predictions
    must be identical to --fwt_batch_size 1."""
    from fwumious_wabbit_tpu.train.loop import main as cli_main

    (tmp_path / "vw_namespace_map.csv").write_text("A,a\nB,b\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(
        f"{1 if i % 2 else -1} |A a{i % 6} |B b{i % 4}\n" for i in range(40)
    ))
    common = ["--data", str(data), "--keep", "A", "--keep", "B",
              "-b", "18", "--adaptive", "-l", "0.1", "--fwt_platform", "cpu"]
    assert cli_main(common + ["--fwt_exact", "-p", str(tmp_path / "exact.out")]) == 0
    assert cli_main(common + ["--fwt_batch_size", "1",
                              "-p", str(tmp_path / "b1.out")]) == 0
    exact = (tmp_path / "exact.out").read_text()
    assert exact == (tmp_path / "b1.out").read_text()
    assert len(exact.splitlines()) == 40


@pytest.mark.parametrize("extra", [
    ["--fwt_batch_cap", "4", "--fwt_batch_mean", "on"],
    ["--fwt_compile_cache", "off"],
    ["--hogwild_training", "--hogwild_threads", "4"],
])
def test_accepted_flag_smoke(tmp_path, extra):
    """Remaining knobs parse and train end-to-end: the batch-multiplicity
    cap, the compile-cache switch, and the hogwild flags (accepted;
    asynchrony maps to batched data parallelism, SURVEY §2.4)."""
    from fwumious_wabbit_tpu.train.loop import main as cli_main

    (tmp_path / "vw_namespace_map.csv").write_text("A,a\n")
    data = tmp_path / "d.vw"
    data.write_text("".join(f"{1 if i % 2 else -1} |A a{i % 4}\n" for i in range(24)))
    rc = cli_main(["--data", str(data), "--keep", "A", "-b", "16",
                   "--adaptive", "-l", "0.1", "--fwt_platform", "cpu",
                   "--fwt_batch_size", "8", "-p", str(tmp_path / "p.out"),
                   *extra])
    assert rc == 0
    assert len((tmp_path / "p.out").read_text().splitlines()) == 24


@pytest.mark.skipif(native.load() is None, reason="no native toolchain")
def test_inband_command_after_empty_line_is_never_seen(tmp_path):
    """An in-band flush AFTER the empty-line end-of-stream marker must NOT
    abort: the stream ended before it (the C engine resolves stop vs abort
    by byte offset now that empty-line detection lives in the parse walk)."""
    data = write_dataset(tmp_path, rows=50)
    text = data.read_text()
    with open(data, "w") as f:
        f.write("".join(text.splitlines(keepends=True)[:30]))
        f.write("\n")  # empty line = EOF
        f.write("flush\n")
        f.write("".join(text.splitlines(keepends=True)[30:]))
    out = run(tmp_path, data, [], "cutflush.out")
    assert len(out.splitlines()) == 30
    out_py = run(tmp_path, data, ["--fwt_no_native"], "cutflush_py.out")
    assert out == out_py


@pytest.mark.skipif(native.load() is None, reason="no native toolchain")
def test_empty_line_stop_with_parallel_shards(tmp_path):
    """Early empty line in a block wide enough to span every parse shard:
    later shards parse post-EOF bytes and must be discarded wholesale."""
    from fwumious_wabbit_tpu.train.loop import native_batch_stream

    data = write_dataset(tmp_path, rows=20000)
    text = data.read_text()
    lines = text.splitlines(keepends=True)
    with open(data, "w") as f:
        f.write("".join(lines[:100]))
        f.write("\n")  # EOF marker at ~0.5% into the block
        f.write("".join(lines[100:]))
    argv = ["--keep", "A", "--keep", "B", "-b", "20", "--adaptive",
            "-l", "0.1", "--data", str(data), "--fwt_batch_size", "64"]
    args = build_parser().parse_args(argv)
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    mi = ModelInstance.from_cmdline(args, vw)
    # force multi-threaded parsing regardless of host core count
    import fwumious_wabbit_tpu.native as fw_native

    orig = fw_native.NativeIngest.__init__

    def patched(self, mi_, vw_, num_threads=None):
        orig(self, mi_, vw_, num_threads=4)

    fw_native.NativeIngest.__init__ = patched
    try:
        total = sum(k for _bd, k in
                    native_batch_stream(args, mi, vw, 64))
    finally:
        fw_native.NativeIngest.__init__ = orig
    assert total == 100
