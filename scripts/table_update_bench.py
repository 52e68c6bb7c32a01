#!/usr/bin/env python3
"""The sparse AdaGrad table update on the card: XLA's scatter path against
the floor of any whole-table sweep.

``ops/adagrad.ScopedOptimizer.apply_rows`` (scatter-add g², re-gather the
bumped accumulator, rated scatter-subtract) is timed at the table sizes
and update counts of the BASELINE config-4 step (B=32768, two FFM fields:
K = 65,536 row updates per step into a 2^26 or 2^29-weight FFM table; the
LR table's 2^25 weights take ~14 updates per example). Beside it, a donated
pass that reads and writes every row of ``w`` and ``acc`` once: the
2·(|w|+|acc|) bytes a table sweep moves on every call, whatever its route.
If the scatter is below that floor, no sweep kernel can beat it.

Usage: python scripts/table_update_bench.py [--reps N]
Prints one JSON line per table size; fails when JAX finds no GPU.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B = 32768
CASES = [  # (table, log2 weights, row updates per step)
    ("ffm", 26, B * 2),
    ("ffm", 29, B * 2),
    ("lr", 25, B * 14),
]


def timed(fn, args_list, reps):
    """Median ms per call over ``reps`` calls, each window ending in
    block_until_ready; ``args_list`` rotates the inputs so repeated ids
    do not sit in L2."""
    import jax

    out = None
    for a in args_list[:2]:  # compile + warm
        out = fn(*a)
    jax.block_until_ready(out)
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        out = fn(*args_list[i % len(args_list)])
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), float(np.min(times))


def main():
    import jax
    import jax.numpy as jnp

    import bench
    from fwumious_wabbit_tpu.ops import tables
    from fwumious_wabbit_tpu.ops.adagrad import OPT_ADAGRAD_LUT, ScopedOptimizer
    from fwumious_wabbit_tpu.utils.gpu import card_line, require_gpu

    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 30
    dev = require_gpu()[0]
    peak = bench.peak_hbm_bytes_s(dev.device_kind)
    print(f"# card: {card_line()}", file=sys.stderr)
    # the config-4 optimizer: --adaptive --power_t 0 (AdaGrad LUT), batch-mean
    # counts already applied upstream (pre_scaled)
    opt = ScopedOptimizer(OPT_ADAGRAD_LUT, 0.1, 0.0, 0.0, batch_mean=True)

    # the table pair is a carried state: each call donates it and the next
    # call takes the result, as the train step does
    state = {}

    def scatter(rid, grows):
        state["t"] = upd(*state["t"], rid, grows)
        return state["t"]

    def sweep():
        state["t"] = stream(*state["t"])
        return state["t"]

    upd = jax.jit(lambda w, acc, rid, g: opt.apply_rows(w, acc, rid, g,
                                                        pre_scaled=True),
                  donate_argnums=(0, 1))
    # every element of both tables read and written once
    stream = jax.jit(lambda w, acc: (w - 1e-9 * acc, acc + 1e-9),
                     donate_argnums=(0, 1))

    for name, bits, K in CASES:
        R = (1 << bits) // tables.LANE
        state["t"] = (jnp.zeros((R, tables.LANE), jnp.float32),
                      jnp.zeros((R, tables.LANE), jnp.float32))
        rng = np.random.default_rng(bits)
        inputs = [
            (jnp.asarray(rng.integers(0, R, K).astype(np.int32)),
             jnp.asarray((rng.normal(size=(K, tables.LANE)) * 0.01)
                         .astype(np.float32)))
            for _ in range(4)
        ]
        xla_med, xla_min = timed(scatter, inputs, reps)
        sweep_med, sweep_min = timed(sweep, [()], reps)
        table_bytes = 2 * R * tables.LANE * 4  # w + acc
        floor_ms = 2 * table_bytes / peak * 1e3
        print(json.dumps({
            "table": name, "log2_weights": bits, "row_updates": K,
            "device_kind": dev.device_kind,
            "xla_apply_rows_ms": round(xla_med, 4),
            "xla_apply_rows_min_ms": round(xla_min, 4),
            "full_pass_ms": round(sweep_med, 4),
            "full_pass_min_ms": round(sweep_min, 4),
            "full_pass_bytes": 2 * table_bytes,
            "full_pass_gb_s": round(2 * table_bytes / (sweep_med / 1e3) / 1e9, 1),
            "sweep_floor_at_peak_ms": round(floor_ms, 4),
        }))
        del state["t"], inputs


if __name__ == "__main__":
    main()
