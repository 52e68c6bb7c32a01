"""Mode-controlled A/B: the Eat-Rate packed train step with the
vocabulary-encoded transfer (--fwt_vocab) ON vs OFF, interleaved in ONE
process.

What it answers (run on the GPU):
  1. step: does the device-side dictionary decode (12 row-gathers +
     integer lane selects per batch, fused into the scanned step) cost
     measurable step time? Per-environment rules (CLAUDE.md), only
     interleaved same-process timings are comparable.
  2. transfer: the H2D rate of the two payloads (38 vs 58 B/example on
     the b=25 benchmark schema) — the vocab encoding's whole purpose.

Usage: python scripts/vocab_ab.py [--rows 500000] [--reps 4] [--windows 3]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args()

    import bench as B
    from fwumious_wabbit_tpu.config.cmdline import build_parser
    from fwumious_wabbit_tpu.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu.models.model import FwModel
    from fwumious_wabbit_tpu.train.loop import native_batch_stream
    from fwumious_wabbit_tpu.train import packed as packed_mod

    import jax

    data = B.ensure_dataset(args.rows)
    K = 8

    a = build_parser().parse_args(B._base_argv(data))
    vw = VwNamespaceMap.from_dataset_dir(a.data)
    mi = ModelInstance.from_cmdline(a, vw)

    setups = {}
    for mode in ("off", "on"):
        model = FwModel(mi)
        vstate = packed_mod.VocabTransferState() if mode == "on" else None
        staged, spec = [], ((), (), (), ())
        for bd, k in native_batch_stream(a, mi, vw, 32768,
                                         count_keys={"lr": 0}):
            if k != 32768:
                continue
            bd, *spec = packed_mod.prepare_for_transfer(
                bd, mi, vocab_state=vstate)
            staged.append(bd)
            if len(staged) >= K:
                break
        lay = packed_mod.layout_of(staged[0], *spec)
        host_buf = packed_mod.pack(lay, staged)
        buf = jax.device_put(host_buf)
        vargs = ()
        if lay.vocabs:
            snap = packed_mod.export_vocab(vstate.venc, lay.vocabs[0])
            vdev = jax.device_put(snap)
            _ = np.asarray(vdev[:1, :1])
            vargs = (vdev,)
        if vstate is not None:
            vstate.close()
        step = packed_mod.make_packed_train_step(model, lay, K)
        params = model.init_params()
        for _ in range(3):  # compile + donation warm-up
            params, preds = step(params, buf, *vargs)
        _ = float(preds[0, 0])
        print(f"vocab={mode}: payload "
              f"{host_buf.nbytes / K / 32768:.1f} B/example")
        setups[mode] = [step, params, buf, vargs, host_buf]

    print(f"# interleaved windows ({args.windows}x{args.reps} reps/mode, "
          f"B=32768 K={K})")
    rates = {m: [] for m in setups}
    trates = {m: [] for m in setups}
    for w in range(args.windows):
        for mode in setups:
            step, params, buf, vargs, host_buf = setups[mode]
            t0 = time.perf_counter()
            for _ in range(args.reps):
                params, preds = step(params, buf, *vargs)
            _ = float(preds[-1, -1])  # force completion
            dt = time.perf_counter() - t0
            setups[mode][1] = params
            r = args.reps * K * 32768 / dt
            rates[mode].append(r)
            # transfer of the same payload, forced
            t0 = time.perf_counter()
            o = jax.device_put(host_buf)
            _ = np.asarray(o[:1, :1])
            tdt = time.perf_counter() - t0
            trates[mode].append(K * 32768 / tdt)
            print(f"window {w} vocab={mode}: step {r:,.0f} ex/s "
                  f"({dt / args.reps * 1e3:.1f} ms/superbatch), "
                  f"transfer {K * 32768 / tdt:,.0f} ex/s "
                  f"({host_buf.nbytes / tdt / 1e6:.0f} MB/s)")
    for mode in setups:
        print(f"vocab={mode}: step mean {np.mean(rates[mode]):,.0f} "
              f"best {max(rates[mode]):,.0f} ex/s; transfer mean "
              f"{np.mean(trates[mode]):,.0f} ex/s")


if __name__ == "__main__":
    main()
