#!/usr/bin/env python
"""Stage breakdown of the host ingest producer on the Eat-Rate schema.

Times, over the same input file (best of R passes each, single process):

  1. parse+translate only   (fwn_translate_block, no batch fill)
  2. batch stream            (parse+translate+fill, no counts)
  3. + multiplicity counts   (count_keys={'lr': 0} — the production train config)
  4. + prepare_for_transfer + pack (the full producer work per superbatch)

The deltas attribute producer time to each stage; compare (2)/(3) with
bench.py's ingest_ex_s and the 788k cache-train bar (BASELINE.md). CPU-only
(no device).

Usage: python scripts/ingest_breakdown.py [--rows N] [--reps R]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=3)
    opts = ap.parse_args()

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "benchmod", Path(__file__).resolve().parent.parent / "bench.py")
    bm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bm)

    from fwumious_wabbit_tpu.config.cmdline import build_parser
    from fwumious_wabbit_tpu.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu.train import packed as packed_mod
    from fwumious_wabbit_tpu.train.loop import native_batch_stream
    from fwumious_wabbit_tpu import native as fw_native

    data = bm.ensure_dataset(opts.rows)
    args = build_parser().parse_args(bm._base_argv(data))
    vw = VwNamespaceMap.from_dataset_dir(args.data)
    mi = ModelInstance.from_cmdline(args, vw)
    raw = Path(data).read_bytes()
    n_lines = raw.count(b"\n")
    print(f"rows {n_lines}  bytes {len(raw):,}")

    def best(fn):
        b = float("inf")
        for _ in range(opts.reps):
            t0 = time.perf_counter()
            n = fn()
            b = min(b, time.perf_counter() - t0)
        return n / b, b

    # 1. parse+translate only: feed line-aligned chunks
    chunks = []
    i = 0
    while i < len(raw):
        j = raw.rfind(b"\n", i, i + (16 << 20)) + 1
        if j <= i:
            break
        chunks.append(raw[i:j])
        i = j

    def translate_only():
        ni = fw_native.NativeIngest(mi, vw)
        ni.set_build_records(False)
        total = 0
        for ch in chunks:
            total += ni.translate_block(ch)
        return total

    r1, _ = best(translate_only)
    print(f"1. parse+translate only : {r1:,.0f} ex/s ({1e6/r1:.3f} us/ex)")

    # 2. batch stream, no counts
    def stream(count_keys):
        def run():
            n = 0
            for _bd, k in native_batch_stream(args, mi, vw, 32768,
                                              count_keys=count_keys):
                n += k
            return n
        return run

    r2, _ = best(stream(None))
    print(f"2. stream (fill, no counts): {r2:,.0f} ex/s ({1e6/r2:.3f} us/ex)")

    r3, _ = best(stream({"lr": 0}))
    print(f"3. stream + lr counts      : {r3:,.0f} ex/s ({1e6/r3:.3f} us/ex)")

    # 4. + transfer prep + pack (fresh vocab state per rep; steady-state
    # reps reuse warmed dictionaries via an outer warm pass)
    def producer():
        vstate = packed_mod.VocabTransferState()
        n = 0
        group, glay = [], None
        for bd, k in native_batch_stream(args, mi, vw, 32768,
                                         count_keys={"lr": 0}):
            n += k
            if k != 32768:
                continue
            slim, *spec = packed_mod.prepare_for_transfer(
                bd, mi, vocab_state=vstate)
            lay = packed_mod.layout_of(slim, *spec)
            if lay is None or (glay is not None
                               and lay.signature != glay.signature):
                group, glay = ([slim], lay) if lay is not None else ([], None)
                continue
            glay = lay
            group.append(slim)
            if len(group) == 8:
                packed_mod.pack(glay, group)
                group = []
        vstate.close()
        return n

    r4, _ = best(producer)
    print(f"4. producer total (+prep+pack): {r4:,.0f} ex/s ({1e6/r4:.3f} us/ex)")
    print(f"   deltas us/ex: fill+stream={1e6/r2 - 1e6/r1:.3f}, "
          f"counts={1e6/r3 - 1e6/r2:.3f}, prep+pack={1e6/r4 - 1e6/r3:.3f}")


if __name__ == "__main__":
    main()
