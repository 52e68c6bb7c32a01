"""Device-side composition profile of the packed LR train step.

Times, in ONE process (interleaved reps, so that all variants share one
card and one window), the full packed train step against ablated
variants on the same device-resident superbatch:

  full      — production packed train step (unpack + K steps)
  forward   — unpack + forward only (gathers + dense + loss), no updates
  no_counts — full step with the batch-mean multiplicity cap ablated

The deltas attribute the step's µs/ex to the update/scatter path, the
counts scaling, and the forward. (An earlier no_dedup variant was void:
the monkeypatch restored tables.dedup_rows before jit TRACING happened
at the first warm call, and the production batch-mean path routes
through expand_scalar_grads_dedup anyway — it compiled the identical
program as `full`.) Usage: python scripts/step_profile.py [--bits 25]
"""

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
from fwumious_wabbit_tpu.config.cmdline import build_parser  # noqa: E402
from fwumious_wabbit_tpu.config.model_instance import ModelInstance  # noqa: E402
from fwumious_wabbit_tpu.config.vwmap import VwNamespaceMap  # noqa: E402
from fwumious_wabbit_tpu.models.model import FwModel  # noqa: E402
from fwumious_wabbit_tpu.train.loop import (  # noqa: E402
    configure_compile_cache, native_batch_stream,
)
from fwumious_wabbit_tpu.train import packed as P  # noqa: E402

configure_compile_cache()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main() -> int:
    K = 8
    data = bench.ensure_dataset(1_000_000)
    args = build_parser().parse_args(bench._base_argv(data))
    vw = VwNamespaceMap.from_dataset_dir(args.data)
    mi = ModelInstance.from_cmdline(args, vw)
    staged = []
    for bd, k in native_batch_stream(args, mi, vw, 32768,
                                     count_keys={"lr": 0}):
        if k == 32768:
            staged.append(bd)
        if len(staged) >= K:
            break
    packs = [P.prepare_for_transfer(dict(b), mi, vocab_state=None)
             for b in staged]
    lay = P.layout_of(packs[0][0], *tuple(packs[0][1:]))
    buf = P.pack(lay, [p[0] for p in packs])
    warm = jax.device_put(buf)
    _ = np.asarray(warm[:1, :1])

    variants = {}

    model = FwModel(mi)
    variants["full"] = (model, P.make_packed_train_step(model, lay, K))

    # forward-only: scan the predict body over the unpacked rows
    def fwd_inner(p, bd):
        return model.predict(p, bd)

    def packed_fwd(params, b):
        def body(p, row):
            out = fwd_inner(p, P.unpack_row(row, lay))
            return p, out
        return jax.lax.scan(body, params, b)[1]

    variants["forward"] = (model, jax.jit(packed_fwd))

    # no_counts: same model class with batch_mean disabled
    mi2 = ModelInstance.from_cmdline(args, vw)
    m2 = FwModel(mi2, batch_mean_mode="off")
    variants["no_counts"] = (m2, P.make_packed_train_step(m2, lay, K))

    # warm all
    states = {}
    for name, (m, fn) in variants.items():
        p0 = m.init_params()
        if name == "forward":
            out = fn(p0, warm)
            _ = float(np.asarray(out).reshape(-1)[0])
            states[name] = (p0, fn)
        else:
            p0, preds = fn(p0, warm)
            _ = float(preds[0, 0])
            states[name] = (p0, fn)

    results = {name: [] for name in variants}
    for rep in range(4):
        for name in variants:
            p, fn = states[name]
            t0 = time.perf_counter()
            for _ in range(4):
                if name == "forward":
                    out = fn(p, warm)
                else:
                    p, out = fn(p, warm)
            _ = float(np.asarray(out).reshape(-1)[-1])
            dt = (time.perf_counter() - t0) / 4
            states[name] = (p, fn)
            results[name].append(dt * 1e3)
    n = K * 32768
    print("variant       ms/superbatch (reps)      ex/s (best)")
    for name, times in results.items():
        best = min(times)
        print(f"{name:12s} {' '.join(f'{t:7.1f}' for t in times)}   "
              f"{n/best*1e3:,.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
