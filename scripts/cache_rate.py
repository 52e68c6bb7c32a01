#!/usr/bin/env python3
"""Host rates of the input record cache (.fwcache) through the native
ingest engine, on the CPU only: a text pass without ``-c``, the first
``-c`` pass (parse + cache write) and a second ``-c`` pass (cache read),
each streamed to the end in batches of 32768 with the Eat-Rate LR flags.

``--tree DIR`` imports the package from another checkout (for example an
unpacked parent commit) while the data comes from this one, so two
versions can be compared on the same rows: run parent, change, change,
parent. Data and caches live under ``.bench_cache/`` of this checkout.

Usage: python scripts/cache_rate.py [--rows N] [--reps N] [--tree DIR]
Prints one JSON line: the median ex/s of each pass and the cache's bytes.
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tree", type=Path, default=ROOT)
    opts = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"

    sys.path.insert(0, str(ROOT))
    import bench

    work = ROOT / ".bench_cache" / "cache_rate"
    work.mkdir(parents=True, exist_ok=True)
    data = work / f"eat_rate_{opts.rows}.vw"
    if not data.exists():
        bench.write_namespace_map(work)
        bench.generate_dataset(data, opts.rows, seed=1)
    flags = bench.eat_rate_flags() + ["--data", str(data)]
    del sys.modules["bench"]

    sys.path.insert(0, str(opts.tree.resolve()))
    for name in [m for m in sys.modules if m.startswith("fwumious_wabbit_tpu")]:
        del sys.modules[name]
    from fwumious_wabbit_tpu import native
    from fwumious_wabbit_tpu.config.cmdline import build_parser
    from fwumious_wabbit_tpu.config.model_instance import ModelInstance
    from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap
    from fwumious_wabbit_tpu.ingest import cache
    from fwumious_wabbit_tpu.train.producer import native_batch_stream

    if native.load() is None:
        raise SystemExit("the native ingest engine did not build or load")
    vw = VwNamespaceMap.from_dataset_dir(str(data))
    cpath = Path(cache.cache_path_for(str(data)))

    def rate(extra) -> float:
        args = build_parser().parse_args(flags + extra)
        mi = ModelInstance.from_cmdline(args, vw)
        n = 0
        t0 = time.perf_counter()
        for _bd, k in native_batch_stream(args, mi, vw, 32768,
                                          count_keys={"lr": 0}):
            n += k
        return n / (time.perf_counter() - t0)

    runs = {"text": [], "write": [], "read": []}
    try:
        for _ in range(opts.reps):
            cpath.unlink(missing_ok=True)
            runs["text"].append(rate([]))
            runs["write"].append(rate(["-c"]))
            size = cpath.stat().st_size
            runs["read"].append(rate(["-c"]))
    finally:
        cpath.unlink(missing_ok=True)
    print(json.dumps({
        "tree": str(opts.tree), "rows": opts.rows, "cache_bytes": size,
        **{f"{k}_ex_s": round(statistics.median(v)) for k, v in runs.items()},
    }))


if __name__ == "__main__":
    main()
