#!/usr/bin/env python3
"""Bring-up check: the CLI's train, predict and serve path on one NVIDIA GPU
at the widths of BASELINE config 4, checked against the repo's references.

Everything runs in THIS process (a second JAX process could not get the
card's memory; only ``make`` and ``nvidia-smi`` run as children). Phases,
each printing its tolerance and result; any failure ends the run non-zero:

1. env      — card, JAX, devices, compile-cache directory, native engine.
2. train    — CLI ``main()`` on 1.5M generated Eat-Rate rows (-c, -f,
              --save_resume; 46 packed steps at B=32768, 2^29 FFM weights
              + AdaGrad state; the FFM learns this schema's label rule only
              after ~30 steps), then a second pass from that model that
              replays the packed-payload cache and must compile no step
              program anew; then a short run of the same model with a ReLU
              tower (the manual backward of train/step.py).
3. compare  — one train step from identical params (phase 2's trained
              tables) and batch on the GPU and on the CPU backend of this
              process (the plain reference), both at precision HIGHEST; the
              steps at DEFAULT (TF32 on the GPU), with and without the table
              selections at DEFAULT too, are printed, and the tower's must
              fall outside the limits.
4. predict  — ``-t -i`` on held-out rows through the device engine against
              the embedded C++ engine (train/predict.py).
5. serve    — the TCP daemon's device engine on a thread of this process:
              request lines, ``flush``, ``hogwild_load``.

``--four`` runs only the sharded path on four cards: the same model
trained with ``--fwt_data_axis 2 --fwt_table_axis 2`` under the a2a and the
psum exchange, each against the single-card run of the same data; the first
card must peak within one table shard of the others.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
the line before it is the card's name and power limit.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import shutil
import socket
import sys
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402  (the Eat-Rate generator and the config-4 flags)
from fwumious_wabbit_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402
from fwumious_wabbit_tpu.utils.gpu import card_line, require_gpu  # noqa: E402

# GPU step vs the CPU step: scatter-add with atomics sums duplicate ids in
# another order on every run, and the two backends' pow/exp differ in ulps
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
# the device engine vs the embedded C++ engine on '%.6f' predictions
PREDICT_TOL = 1e-5
# the daemon vs phase 4's file: the same device computation at another
# batch padding, printed to 6 decimals — equal up to one unit of the last
# printed digit
SERVE_TOL = 1.01e-6
# progressive logloss of the first pass must end below this
LOGLOSS_MAX = 0.69

STEP_PROGRAMS = ("packed_steps", "train_step", "predict_step")


@dataclass(frozen=True)
class Smoke:
    """Sizes of one smoke run; the defaults are config 4 at full width."""

    rows: int = 1_500_000
    heldout: int = 50_000
    batch: int = 32768
    lr_bits: int = 25
    ffm_bits: int = 29
    tower_rows: int = 8 * 32768
    serve_lines: int = 300
    four_rows: int = 8 * 32768
    # the learning checks of the train phase: a few thousand rows of this
    # schema (the CPU tests' size) are too few to learn from
    check_learning: bool = True


def log(msg: str) -> None:
    print(msg, flush=True)


def model_flags(cfg: Smoke, tower: bool = False) -> list:
    argv = bench.eat_rate_flags(cfg.lr_bits) + bench.ffm_flags(cfg.ffm_bits)
    if tower:  # the ReLU tower of __graft_entry__._flagship. Its dense
        # gradients are summed over the whole batch: at B=32768 the LR/FFM
        # rate (0.1, power_t 0) swings the logits to saturation, so the
        # tower takes AdaGrad's bounded steps at a tenth of that rate
        argv += ["--nn_layers", "1", "--nn", "0:width:20",
                 "--nn", "0:activation:relu", "--nn_topology", "one",
                 "--nn_power_t", "0.5", "--nn_learning_rate", "0.01"]
    return argv + ["--fwt_batch_size", str(cfg.batch)]


def read_floats(path: Path) -> np.ndarray:
    return np.array(path.read_bytes().split(), dtype=np.float64)


def read_labels(path: Path) -> np.ndarray:
    with open(path, "rb") as f:
        return np.array([float(line.split(b" ", 1)[0]) > 0 for line in f])


def logloss(p: np.ndarray, y: np.ndarray) -> float:
    p = np.clip(p, 1e-7, 1 - 1e-7)
    return float(-np.mean(np.where(y, np.log(p), np.log(1 - p))))


def peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class CompileWatch:
    """Counts JAX backend compiles and names what the persistent cache
    served or missed while active."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.hits: list[str] = []
        self.misses: list[str] = []
        self._on = False
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        self._logger = logging.getLogger("jax._src.compiler")
        self._handler = _NameHandler(self)

    def _duration(self, event, duration, **_kw):
        if self._on and event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration

    def __enter__(self):
        self.seconds, self.hits, self.misses = 0.0, [], []
        self._level, self._prop = self._logger.level, self._logger.propagate
        self._logger.setLevel(logging.DEBUG)
        self._logger.propagate = False
        self._logger.addHandler(self._handler)
        self._on = True
        return self

    def __exit__(self, *exc):
        self._on = False
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._level)
        self._logger.propagate = self._prop
        return False

    def step_misses(self) -> list[str]:
        return [m for m in self.misses if any(s in m for s in STEP_PROGRAMS)]


class _NameHandler(logging.Handler):
    def __init__(self, watch: CompileWatch):
        super().__init__(logging.DEBUG)
        self.watch = watch

    def emit(self, record):
        msg = record.getMessage()
        name = msg.split("'")[1] if msg.count("'") >= 2 else msg
        if msg.startswith("Persistent compilation cache hit"):
            self.watch.hits.append(name)
        elif msg.startswith("PERSISTENT COMPILATION CACHE MISS"):
            self.watch.misses.append(name)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(want_devices: int = 1) -> dict:
    import jax

    from fwumious_wabbit_tpu import native

    log("== env")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}; devices: {jax.devices()}")
    devices = require_gpu()
    if len(devices) < want_devices:
        raise RuntimeError(f"need {want_devices} GPUs, JAX sees {len(devices)}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir or 'off'}")
    loaded = native.load() is not None
    log(f"native C++ engine loaded: {loaded}")
    if not loaded:
        raise RuntimeError("the native C++ engine did not build or load")
    d = devices[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def make_data(cfg: Smoke, work: Path) -> tuple[Path, Path]:
    """Training rows and held-out rows (another seed) of the Eat-Rate
    schema, with the namespace map beside them."""
    t0 = time.perf_counter()
    bench.write_namespace_map(work)
    data, held = work / "train.vw", work / "heldout.vw"
    bench.generate_dataset(data, cfg.rows, seed=1)
    bench.generate_dataset(held, cfg.heldout, seed=2)
    log(f"data: {cfg.rows} train + {cfg.heldout} held-out rows in "
        f"{time.perf_counter() - t0:.1f} s")
    return data, held


def _train_pass(cfg, argv, watch, device, what) -> dict:
    with watch:
        t0 = time.perf_counter()
        res = bench.cli_run(argv, scratch=Path(argv[argv.index("-p") + 1]).parent)
        wall = time.perf_counter() - t0
    ex_s = res["examples"] / max(res["elapsed"], 1e-9)
    log(f"{what}: {res['examples']} rows, wall {wall:.1f} s, compile "
        f"{watch.seconds:.1f} s, peak_bytes_in_use {peak_bytes(device)}, "
        f"{ex_s:,.0f} ex/s (smoke, not a benchmark) on {card_line()}")
    return res


def phase_train(cfg: Smoke, work: Path, data: Path, watch: CompileWatch,
                device, tower: bool = False) -> Path | None:
    """CLI training; returns the saved model's path (the tower run saves
    none)."""
    import jax

    log("== train" + (" (ReLU tower)" if tower else " (config 4)"))
    tag = "tower" if tower else "m"
    model1 = work / f"{tag}.fwt"
    if tower:
        # the tower run: a prefix of the training rows, one pass
        part = work / "tower.vw"
        with open(data, "rb") as src, open(part, "wb") as dst:
            for _ in range(cfg.tower_rows):
                dst.write(src.readline())
        data = part
    preds1 = work / f"{tag}_pass1.txt"
    argv = model_flags(cfg, tower) + ["--data", str(data), "-c", "-p",
                                      str(preds1)]
    if not tower:
        argv += ["-f", str(model1), "--save_resume"]
    _train_pass(cfg, argv, watch, device, "pass 1")
    y = read_labels(data)
    p1 = read_floats(preds1)
    _check_preds(p1, len(y), "pass 1")
    if tower:  # a short run: it checks the tower's path, not learning
        return None
    q = np.array_split(np.arange(len(y)), 4)
    lls = [logloss(p1[i], y[i]) for i in q]
    log(f"pass 1 progressive logloss by quarter: "
        f"{', '.join(f'{v:.4f}' for v in lls)} (limit < {LOGLOSS_MAX}, falling)")
    if cfg.check_learning and not (lls[-1] < LOGLOSS_MAX and lls[-1] < lls[0]):
        raise AssertionError(f"pass 1 logloss {lls} is not below "
                             f"{LOGLOSS_MAX} and falling")

    # pass 2: the multipass recipe (README): resume from the model, replay
    # the packed-payload cache recorded by pass 1
    pack = Path(str(data) + ".fwpack")
    if not pack.exists():
        raise AssertionError(f"pass 1 recorded no pack cache at {pack}")
    recorded = pack.stat().st_mtime_ns
    preds2, model2 = work / "m_pass2.txt", work / "m2.fwt"
    argv2 = model_flags(cfg) + ["--data", str(data), "-c", "-p", str(preds2),
                                "-i", str(model1), "-f", str(model2),
                                "--save_resume"]
    _train_pass(cfg, argv2, watch, device, "pass 2")
    if pack.stat().st_mtime_ns != recorded:
        raise AssertionError("pass 2 re-recorded the pack cache instead of "
                             "replaying it")
    p2 = read_floats(preds2)
    _check_preds(p2, len(y), "pass 2")
    ll1, ll2 = logloss(p1, y), logloss(p2, y)
    log(f"progressive logloss pass 1 {ll1:.4f} → pass 2 {ll2:.4f} (must fall)")
    if cfg.check_learning and not ll2 < ll1:
        raise AssertionError("pass 2 did not improve on pass 1")
    cached = jax.config.jax_compilation_cache_dir
    log(f"pass 2 persistent-cache hits {len(watch.hits)}, misses "
        f"{len(watch.misses)} {sorted(set(watch.misses))}")
    if cached and watch.step_misses():
        raise AssertionError(f"pass 2 compiled step programs anew: "
                             f"{watch.step_misses()}")
    model2.unlink()
    return model1


def _check_preds(p: np.ndarray, n: int, what: str) -> None:
    ok = p.shape == (n,) and np.all(np.isfinite(p)) and np.all((p > 0) & (p < 1))
    log(f"{what}: {p.size} predictions, finite and in (0,1): {bool(ok)}")
    if not ok:
        raise AssertionError(f"{what}: bad predictions (shape {p.shape}, "
                             f"min {np.nanmin(p)}, max {np.nanmax(p)})")


def _first_batch(cfg: Smoke, args, mi, vw, model):
    from fwumious_wabbit_tpu.train.loop import host_count_keys, native_batch_stream

    for bd, n in native_batch_stream(args, mi, vw, cfg.batch,
                                     count_keys=host_count_keys(model)):
        if n == cfg.batch:
            return bd
    raise AssertionError("no full batch in the data")


def _touched_rows(model, bd) -> dict:
    from fwumious_wabbit_tpu.ops import tables

    lr_ids = np.asarray(model.lr_ids_combos(
        {k: np.asarray(v) for k, v in bd.items()})[0])
    rows = {"lr": np.unique(lr_ids >> tables.LANE_BITS)}
    if model.has_ffm:
        rid = np.asarray(bd["ffm_ids"]) >> tables.LANE_BITS
        g = model.ffm_spec.rows_per_slab
        rows["ffm"] = np.unique((rid[..., None] + np.arange(g)).reshape(-1))
    return rows


def _gather(params, key, rows) -> np.ndarray:
    import jax.numpy as jnp

    t = params[key]
    return np.asarray(jnp.take(t, jnp.asarray(rows, jnp.int32), axis=0))


@contextlib.contextmanager
def _selections_at(precision):
    """The table selections and dedup sums (ops/tables.EXACT) traced at
    ``precision`` instead of HIGHEST: the control of the compare phase."""
    from fwumious_wabbit_tpu.ops import tables

    saved, tables.EXACT = tables.EXACT, precision
    try:
        yield
    finally:
        tables.EXACT = saved


def phase_compare(cfg: Smoke, data: Path, model_path: Path, device,
                  ref_device, tower: bool = False) -> dict:
    """One train step at these widths on ``device`` and on ``ref_device``
    (the CPU backend) from identical params and batch. The tables are the
    trained ones of ``model_path`` (non-zero weights and accumulators: a
    select of 0.0 is exact at any precision); the tower's layers are
    fresh."""
    import jax

    from fwumious_wabbit_tpu.config.cmdline import build_parser
    from fwumious_wabbit_tpu.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu.models.model import FwModel
    from fwumious_wabbit_tpu.persistence import model_file
    from fwumious_wabbit_tpu.train.step import make_train_step

    log("== compare" + (" (ReLU tower)" if tower else " (config 4)") +
        f": {device.platform} step vs {ref_device.platform} step from the "
        f"trained tables, rtol {STEP_RTOL}, atol {STEP_ATOL}")
    args = build_parser().parse_args(model_flags(cfg, tower) + ["--data", str(data)])
    vw = VwNamespaceMap.from_dataset_dir(args.data)
    mi = ModelInstance.from_cmdline(args, vw)
    model = FwModel(mi)  # the CLI's precision: HIGHEST
    bd = _first_batch(cfg, args, mi, vw, model)
    rows = _touched_rows(model, bd)
    keys = ("lr_w", "lr_acc", "ffm_w", "ffm_acc")
    with jax.default_device(ref_device):
        *_, trained = model_file.load_model(model_path)
    host = jax.device_get(trained)
    del trained
    host.update(jax.device_get(model.init_tower()))
    lr_w = host["lr_w"][rows["lr"]]
    log(f"  start: {np.count_nonzero(lr_w)} of {lr_w.size} lr_w values in "
        f"the touched rows are non-zero")

    def run(m, dev):
        new, pred = make_train_step(m)(jax.device_put(host, dev),
                                       jax.device_put(bd, dev))
        out = {"pred": np.asarray(pred)}
        for k in keys:
            if k in new:
                out[k] = _gather(new, k, rows[k.split("_")[0]])
        return out

    def gap(got, want) -> dict:
        return {k: float(np.max(np.abs(got[k] - want[k]))) for k in want}

    def outside(got, want) -> list:
        return [k for k in want if not np.allclose(
            got[k], want[k], rtol=STEP_RTOL, atol=STEP_ATOL)]

    ref = run(model, ref_device)
    got = run(model, device)
    result = gap(got, ref)
    for k, want in ref.items():
        log(f"  {k}: {want.size} values, max |Δ| {result[k]:.3g}")
        np.testing.assert_allclose(got[k], want, rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=f"{k}: {device.platform} vs "
                                           f"{ref_device.platform}")
    # DEFAULT precision (TF32 on the GPU), not asserted against the
    # reference: the model's own contractions, then (the control) the
    # table selections and dedup sums as well
    relaxed = run(FwModel(mi, precision="default"), device)
    with _selections_at(jax.lax.Precision.DEFAULT):
        control = run(FwModel(mi, precision="default"), device)
    for what, out in (("model contractions at DEFAULT", relaxed),
                      ("control, selections and dedup sums at DEFAULT too",
                       control)):
        log(f"  {what}: vs reference {_fmt(gap(out, ref))}; vs the HIGHEST "
            f"{device.platform} step {_fmt(gap(out, got))}; outside the "
            f"limits: {outside(out, ref) or 'none'}")
    # the tower's dense contractions run in TF32 on the GPU at DEFAULT: the
    # compare must see it there, or it could not see a lost HIGHEST
    if tower and device.platform == "gpu" and not outside(relaxed, ref):
        raise AssertionError("the tower step at DEFAULT is within the limits:"
                             " the compare cannot tell TF32 from HIGHEST")
    return result


def _fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in d.items())


def phase_predict(cfg: Smoke, work: Path, model_path: Path,
                  held: Path) -> np.ndarray:
    from fwumious_wabbit_tpu import native
    from fwumious_wabbit_tpu.config.cmdline import build_parser
    from fwumious_wabbit_tpu.train.loop import main as cli_main
    from fwumious_wabbit_tpu.train.predict import native_predict_eligible

    log(f"== predict: device engine vs embedded C++ engine, max |Δ| ≤ {PREDICT_TOL}")
    dev_out, nat_out = work / "pred_device.txt", work / "pred_native.txt"
    common = ["-t", "-i", str(model_path), "--data", str(held),
              "--fwt_batch_size", str(cfg.batch)]
    t0 = time.perf_counter()
    if cli_main(common + ["-p", str(dev_out), "--fwt_serve_engine", "device"]) != 0:
        raise AssertionError("device predict failed")
    t1 = time.perf_counter()
    nat_argv = common + ["-p", str(nat_out)]
    if not (native_predict_eligible(build_parser().parse_args(nat_argv))
            and native.load() is not None):
        raise AssertionError("the native predict engine would not run")
    if cli_main(nat_argv) != 0:
        raise AssertionError("native predict failed")
    t2 = time.perf_counter()
    dev, nat = read_floats(dev_out), read_floats(nat_out)
    _check_preds(dev, cfg.heldout, "device predict")
    if nat.shape != dev.shape:
        raise AssertionError(f"native engine wrote {nat.size} predictions")
    diff = float(np.max(np.abs(dev - nat)))
    y = read_labels(held)
    log(f"  {dev.size} rows: max |Δ| {diff:.3g}; held-out logloss "
        f"{logloss(dev, y):.4f}; device {t1 - t0:.1f} s, native "
        f"{t2 - t1:.1f} s wall (model load included)")
    if diff > PREDICT_TOL:
        raise AssertionError(f"device vs native predictions differ by {diff}")
    return dev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_lines(f, n: int) -> list[bytes]:
    out = []
    for _ in range(n):
        line = f.readline()
        if not line:
            raise AssertionError(f"server closed after {len(out)} of {n} replies")
        out.append(line.strip())
    return out


def phase_serve(cfg: Smoke, model_path: Path, held: Path,
                expected: np.ndarray) -> None:
    from fwumious_wabbit_tpu.config.cmdline import build_parser
    from fwumious_wabbit_tpu.train.loop import make_serving

    n = cfg.serve_lines
    log(f"== serve: daemon device engine, {n} request lines, flush, "
        f"hogwild_load; replies vs predict phase, max |Δ| ≤ {SERVE_TOL}")
    port = _free_port()
    args = build_parser().parse_args([
        "--daemon", "--foreground", "-i", str(model_path), "--port", str(port),
        "--fwt_serve_engine", "device", "--num_children", "2"])
    serving = make_serving(args)
    if serving is None or serving.native_predictor is not None:
        raise AssertionError("the daemon did not start on the device engine")
    with open(held, "rb") as f:
        lines = [f.readline() for _ in range(n)]
    half = n // 2
    serving.serve_in_background()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
            f = s.makefile("rwb")
            f.write(b"".join(lines[:half]) + b"flush\n")
            f.flush()
            replies = _read_lines(f, half)  # answered without closing
            f.write(f"hogwild_load {model_path}\n".encode())
            f.flush()
            ack = _read_lines(f, 1)[0]
            if ack != b"hogwild_load success":
                raise AssertionError(f"hogwild_load answered {ack!r}")
            f.write(b"".join(lines[half:]))
            f.flush()
            replies += _read_lines(f, n - half)
    finally:
        serving.shutdown()
    got = np.array([float(r) for r in replies])
    diff = float(np.max(np.abs(got - expected[:n])))
    log(f"  {n} replies, flush answered, hogwild_load success; max |Δ| {diff:.3g}")
    if diff > SERVE_TOL:
        raise AssertionError(f"daemon replies differ from predict by {diff}")


def phase_four(cfg: Smoke, work: Path, data: Path, devices,
               mesh: tuple[int, int] = (2, 2)) -> None:
    """The sharded path on a ``mesh`` = (data, table) mesh over ``devices``
    (all of JAX's devices), a2a and psum, against one card. The sharded
    runs go first, so that the devices' peak memory is theirs alone: the
    first device must peak within one table shard of the others."""
    import jax

    from fwumious_wabbit_tpu.config.cmdline import build_parser
    from fwumious_wabbit_tpu.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu.models.model import FwModel
    from fwumious_wabbit_tpu.train.loop import device_startup, run_train_loop

    n_data, n_table = mesh
    log(f"== four: --fwt_data_axis {n_data} --fwt_table_axis {n_table}, a2a "
        f"and psum vs one card, rtol {STEP_RTOL}, atol {STEP_ATOL}")
    part = work / "four.vw"
    with open(data, "rb") as src, open(part, "wb") as dst:
        for _ in range(cfg.four_rows):
            dst.write(src.readline())
    keys = ("lr_w", "lr_acc", "ffm_w", "ffm_acc")

    def train(extra, tag):
        out = work / f"four_{tag}.txt"
        args = build_parser().parse_args(
            model_flags(cfg) + ["--data", str(part), "-p", str(out), *extra])
        device_startup(args)
        vw = VwNamespaceMap.from_dataset_dir(args.data)
        mi = ModelInstance.from_cmdline(args, vw)
        t0 = time.perf_counter()
        res = run_train_loop(args, mi, vw, FwModel(mi))
        log(f"  {tag}: {res['examples']} rows in {time.perf_counter() - t0:.1f} s"
            f", a2a dropped {res['a2a_dropped']}")
        return res, read_floats(out)

    sharded, shard_bytes = {}, 0
    for exch in ("a2a", "psum"):
        res, p = train(["--fwt_data_axis", str(n_data), "--fwt_table_axis",
                        str(n_table), "--fwt_exchange", exch], exch)
        if res["a2a_dropped"]:
            raise AssertionError(f"{exch}: {res['a2a_dropped']} occurrences dropped")
        tabs = {}
        for k in keys:
            arr = res["params"][k]
            shard_devs = {s.device for s in arr.addressable_shards}
            if shard_devs != set(devices):
                raise AssertionError(f"{exch} {k} lives on {shard_devs}")
            shard_bytes = max(shard_bytes, arr.nbytes // n_table)
            tabs[k] = np.asarray(arr)
        sharded[exch] = p, tabs
        del res
    peaks = [peak_bytes(d) for d in devices]
    log("  after the sharded runs: " + ", ".join(
        f"device {d.id} peak_bytes_in_use {b}" for d, b in zip(devices, peaks))
        + f"; one shard of the largest table {shard_bytes} bytes")
    if None in peaks:
        if devices[0].platform == "gpu":
            raise AssertionError("a GPU reported no peak_bytes_in_use")
    elif peaks[0] - min(peaks[1:]) > shard_bytes:
        raise AssertionError(f"device {devices[0].id} peaked at {peaks[0]} "
                             f"bytes, more than one shard above the others")

    single, p_single = train([], "single")
    want = {k: np.asarray(single["params"][k]) for k in keys}
    del single
    for exch, (p, tabs) in sharded.items():
        np.testing.assert_allclose(p, p_single, rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=f"{exch} predictions")
        log(f"  {exch} predictions: max |Δ| {np.max(np.abs(p - p_single)):.3g}")
        for k in keys:
            got = tabs[k][: want[k].shape[0]]
            np.testing.assert_allclose(got, want[k], rtol=STEP_RTOL,
                                       atol=STEP_ATOL, err_msg=f"{exch} {k}")
            log(f"  {exch} {k}: {got.size} values on {len(devices)} devices, "
                f"max |Δ| {np.max(np.abs(got - want[k])):.3g}")


# ---------------------------------------------------------------------------


def run(cfg: Smoke, four: bool, work: Path) -> dict:
    import jax

    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    try:
        info = phase_env(4 if four else 1)
        devices = jax.devices()
        if four:
            data, _ = make_data(replace(cfg, rows=cfg.four_rows, heldout=1), work)
            phase_four(cfg, work, data, devices)
            return info
        watch = CompileWatch()
        data, held = make_data(cfg, work)
        model_path = phase_train(cfg, work, data, watch, devices[0])
        phase_train(cfg, work, data, watch, devices[0], tower=True)
        cpu = jax.devices("cpu")[0]
        phase_compare(cfg, data, model_path, devices[0], cpu)
        phase_compare(cfg, data, model_path, devices[0], cpu, tower=True)
        expected = phase_predict(cfg, work, model_path, held)
        phase_serve(cfg, model_path, held, expected)
        return info
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the sharded path, on four cards")
    opts = ap.parse_args(argv)
    configure_compile_cache()  # before the first compile
    require_gpu()  # no card: fail before any phase
    info = run(Smoke(), opts.four, ROOT / ".smoke_work")
    log(card_line())
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
