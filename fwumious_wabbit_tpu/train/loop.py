"""The driver loop — the reference's ``main_fw_loop`` re-shaped for batched
device execution (reference: src/main.rs:96-292).

Semantics preserved:

* records come from the VW text stream or the input cache (``-c``); when a
  cache is being built, every parsed record is appended to it;
* predictions are the *training-path* forward values, written ``{:.6f}`` per
  example to ``-p`` and/or stdout, starting after ``--predictions_after``;
* ``--holdout_after N``: examples ≥ N are predicted but not trained
  (the reference's ``example_num < holdout_after`` check — example numbers
  are 1-based);
* ``--prediction_model_delay D``: each example is predicted with the model
  trained only through example ``i − D`` (training lags a queue of length D);
* ``--testonly``: no updates at all.

Batched mapping: examples are grouped into fixed-size padded batches; a batch
is flushed early when the train/holdout boundary crosses it. Predictions come
out in input order. ``--fwt_batch_size 1`` (or ``--fwt_exact``) reproduces
the reference's per-example trajectory exactly.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

from ..config.model_instance import ModelInstance
from ..config.vwmap import VwNamespaceMap
from ..ingest import cache as fwcache
from ..ingest.parser import FlushCommand, HogwildLoadCommand, VowpalParser
from ..ingest.reader import create_buffered_input
from ..ingest.translator import Batcher, FeatureTranslator
from ..utils.logging import get_logger

# NOTE: models.model / train.step / persistence.model_file import jax and
# are imported lazily at their use sites — the embedded-engine predict
# path (run_native_predict) and --help must not pay the jax import
# (~1-2 s of a cold CLI predict's wall clock; the reference's binary
# starts in milliseconds)

log = get_logger(__name__)


def record_stream(args, vw: VwNamespaceMap):
    """Yield packed u32 records from cache (if valid) or text (writing the
    cache when ``-c``), mirroring the reference's RecordCache drive
    (reference: src/cache.rs:53-131, src/main.rs:213-228)."""
    input_filename = args.data
    use_cache = bool(getattr(args, "cache", False))
    cpath = fwcache.cache_path_for(input_filename)

    if use_cache and Path(cpath).exists():
        try:
            with fwcache.RecordCacheReader(cpath, vw) as reader:
                log.info("using cache file %s", cpath)
                yield from reader
            return
        except (fwcache.StaleCacheError, ValueError) as e:
            log.warning("cache rejected (%s); reparsing", e)

    writer = fwcache.RecordCacheWriter(cpath, vw) if use_cache else None
    parser = VowpalParser(vw)
    stream = create_buffered_input(input_filename)
    try:
        while True:
            # in-band commands in a training FILE abort the run, exactly
            # like the reference (src/main.rs:218-221 propagates the
            # parser's command "error" and exits); they are only
            # meaningful on the serving socket
            rec = parser.next_vowpal(stream)
            if rec.size == 0:
                break
            if writer is not None:
                writer.push_record(rec)
            yield rec
    except BaseException:
        # never publish a truncated cache (the reference only renames the
        # .writing temp on clean completion, src/cache.rs:147-153)
        if writer is not None:
            writer.abort()
        raise
    else:
        if writer is not None:
            writer.write_finish()


def build_cache_without_training(args, vw: VwNamespaceMap) -> int:
    """--build_cache_without_training (reference: src/main.rs:50-94)."""
    n = 0
    for _ in record_stream(args, vw):
        n += 1
    log.info("cache built: %d records", n)
    return n


def _batch_dict(batch) -> dict:
    return {
        "label": batch.label,
        "importance": batch.importance,
        "lr_ids": batch.lr_ids,
        "lr_vals": batch.lr_vals,
        "lr_combos": batch.lr_combos,
        "ffm_ids": batch.ffm_ids,
        "ffm_vals": batch.ffm_vals,
        "ffm_fields": batch.ffm_fields,
    }


# the producer pipeline stages live in train/producer.py; the stream is
# re-exported here because bench.py and the probe scripts import it from
# the loop module
from .producer import native_batch_stream  # noqa: E402,F401

# prediction output + the embedded-engine predict mode live in
# train/predict.py; re-exported for existing imports (tests, bench)
from .predict import (  # noqa: E402,F401
    PredictionWriter,
    native_predict_eligible,
    run_native_predict,
)

# the persistent XLA compile-cache setup lives in utils/compile_cache.py;
# re-exported for existing imports (bench.py, scripts)
from ..utils.compile_cache import configure_compile_cache  # noqa: E402,F401


def host_count_keys(model) -> dict | None:
    """Which host-side multiplicity counts ride the batch: one per scope
    with the batch-mean cap (per-weight for LR: key = id; per-window for
    FFM: key = id >> log2 align, single-row slabs only). None: no counts."""
    keys = {}
    if model.opt_lr.batch_mean:
        keys["lr"] = 0
    if (model.has_ffm and model.opt_ffm.batch_mean
            and model.ffm_spec.rows_per_slab == 1):
        keys["ffm"] = (model.ffm_spec.align - 1).bit_length()
    return keys or None


def _use_native(args, mi) -> bool:
    if getattr(args, "fwt_no_native", False):
        return False
    from .. import native as fw_native

    return fw_native.load() is not None


def run_train_loop(args, mi: ModelInstance, vw: VwNamespaceMap, model: FwModel,
                   params=None) -> dict:
    """The main train/predict loop. Returns {'params', 'examples', 'elapsed'}."""
    from ..train.step import make_predict_step, make_train_step

    testonly = bool(getattr(args, "testonly", False))
    batch_size = max(1, int(getattr(args, "fwt_batch_size", 1024) or 1024))
    if getattr(args, "fwt_exact", False):
        batch_size = 1

    predictions_after = int(getattr(args, "predictions_after", None) or 0)
    holdout_after = getattr(args, "holdout_after", None)
    holdout_after = int(holdout_after) if holdout_after is not None else None
    delay = int(getattr(args, "prediction_model_delay", None) or 0)

    translator = FeatureTranslator(mi)
    batcher = Batcher(batch_size)
    writer = PredictionWriter(
        getattr(args, "predictions", None), bool(getattr(args, "predictions_stdout", False))
    )

    # multi-device: --fwt_data_axis / --fwt_table_axis select a
    # ('data','table') mesh; tables are row-sharded and the
    # explicit-collectives step (parallel/sharded.py) trains, with the
    # exchange strategy from --fwt_exchange (a2a shards the batch over BOTH
    # axes so every device owns distinct examples)
    from ..parallel import mesh as pmesh

    n_table = int(getattr(args, "fwt_table_axis", 1) or 1)
    exchange = getattr(args, "fwt_exchange", "auto") or "auto"
    mesh = pmesh.mesh_from_args(args)
    shard_batch_fn = None
    if mesh is not None:
        if exchange == "auto":
            exchange = "a2a" if n_table > 1 else "psum"
        nshard = mesh.shape[pmesh.DATA_AXIS] * (
            n_table if exchange == "a2a" else 1
        )
        if batch_size % nshard:
            batch_size = ((batch_size + nshard - 1) // nshard) * nshard
        log.info("mesh: %s exchange=%s (batch %d)",
                 dict(mesh.shape), exchange, batch_size)

    if params is None:
        params = model.init_params(mesh=mesh)

    if mesh is not None:
        from ..parallel.sharded import make_sharded_train_step

        # a no-op for params built or loaded on this mesh
        params = pmesh.shard_params(params, pmesh.param_sharding(mesh, params))
        a2a_stats = exchange == "a2a"
        train_step = (
            make_sharded_train_step(
                model, mesh, exchange=exchange,
                capacity_factor=float(getattr(args, "fwt_a2a_capacity", 2.0) or 2.0),
                with_stats=a2a_stats,
            )
            if not testonly else None
        )
        predict_step = make_predict_step(model)  # GSPMD handles sharded params
        both = exchange == "a2a"
        shard_batch_fn = lambda bd: pmesh.shard_batch(bd, mesh, both_axes=both)  # noqa: E731
    else:
        train_step = make_train_step(model) if not testonly else None
        predict_step = make_predict_step(model)

    if mesh is None:
        a2a_stats = False

    # a2a overflow accumulator: a device scalar summed lazily per step (no
    # per-step host sync); fetched once at the end of the run
    a2a_dropped = None

    def call_train(params, bd):
        nonlocal a2a_dropped
        if a2a_stats:
            params, preds, stats = train_step(params, bd)
            d = stats["a2a_dropped"]
            a2a_dropped = d if a2a_dropped is None else a2a_dropped + d
            return params, preds
        return train_step(params, bd)

    example_num = 0
    t0 = time.time()
    t0_cpu = time.process_time()
    t0_thread = time.thread_time()  # main (consumer) thread CPU

    # in-run pipeline counters: busy/stall seconds accumulated INSIDE the
    # timed window by each stage's own thread, so stage rates and
    # pipeline efficiency are self-consistent with the end-to-end rate
    # (probing stages in separate windows on a link that swings 10x made
    # the old efficiency number incoherent — see bench.py). Identities:
    #   producer span  ≈ producer_busy_s + producer_stall_s
    #   transferrer    ≈ xfer_starve_s + xfer_busy_s + xfer_stall_s
    #   consumer       ≈ consumer_starve_s + dispatch_s + writer_stall_s
    #   writer         ≈ (queue wait) + device_wait_s + fetch_force_s
    #                    + write_s
    # device_wait_s is the writer's block_until_ready on each prediction
    # array: the wait for the steps that produce it to finish on the
    # device; fetch_force_s is the device→host copy after that.
    ctr = {
        "producer_busy_s": 0.0, "producer_stall_s": 0.0,
        "xfer_starve_s": 0.0, "xfer_busy_s": 0.0, "xfer_stall_s": 0.0,
        "xfer_bytes": 0, "xfer_puts": 0,
        "consumer_starve_s": 0.0, "dispatch_s": 0.0, "writer_stall_s": 0.0,
        "device_wait_s": 0.0, "fetch_force_s": 0.0, "fetch_count": 0,
        "fetch_bytes": 0,
        "write_s": 0.0,
    }

    def finish_run(params):
        """Drain the delay queue + prediction pipeline, log, and build the
        result dict — shared by the single-host and multi-host tails."""
        if delay > 0 and not testonly and train_step is not None:
            for bd, _n in delayed:
                params, _ = call_train(params, bd)
        _finish_writes()
        writer.close()
        dropped = int(a2a_dropped) if a2a_dropped is not None else 0
        if dropped > 0:
            log.warning(
                "a2a exchange dropped %d occurrence(s) past the static "
                "per-destination capacity this run (their lookups read zero "
                "and their updates were skipped) — raise --fwt_a2a_capacity "
                "if the id distribution is skewed", dropped)
        elapsed = time.time() - t0
        ctr.setdefault("cpu_s_by_thread", {})["consumer"] = (
            time.thread_time() - t0_thread)
        log.info("Elapsed: %.2fs rows: %d (%.0f ex/s)", elapsed, example_num,
                 example_num / max(elapsed, 1e-9))
        return {"params": params, "examples": example_num,
                "elapsed": elapsed, "a2a_dropped": dropped,
                "counters": dict(ctr, elapsed_s=elapsed,
                                 process_cpu_s=time.process_time() - t0_cpu)}

    # delayed-learning queue of (batch_dict, n) when --prediction_model_delay
    delayed: list = []
    delayed_examples = 0

    # device/host overlap: prediction fetches happen on a dedicated writer
    # thread so the wait for a step and its D2H copy never block step
    # dispatch; a bounded queue keeps at most
    # FWT_PIPELINE_DEPTH batches of predictions in flight.
    import queue as _queue
    import threading as _threading

    PIPELINE_DEPTH = int(os.environ.get("FWT_PIPELINE_DEPTH", "3"))
    _wq: _queue.Queue = _queue.Queue(maxsize=PIPELINE_DEPTH)
    _werr: list = []

    # last prediction-fetch force duration, written by the writer thread,
    # read by the packed consumer's adaptive ring engagement (below)
    _fetch_stats = {"last_ms": 0.0}

    def _pred_writer():
        _cpu0 = time.thread_time()
        try:
            while (item := _wq.get()) is not None:
                preds, metas = item
                # ONE host fetch per item: [B] from a single step, [K, B]
                # from a packed one, or [M, K, B] from a fetch-stack — the
                # metas list maps leading rows back to example segments.
                _t0 = time.perf_counter()
                if hasattr(preds, "block_until_ready"):
                    preds.block_until_ready()
                _t1 = time.perf_counter()
                ctr["device_wait_s"] += _t1 - _t0
                arr = np.asarray(preds)
                _dt = time.perf_counter() - _t1
                _fetch_stats["last_ms"] = _dt * 1e3
                ctr["fetch_force_s"] += _dt
                ctr["fetch_count"] += 1
                ctr["fetch_bytes"] += arr.nbytes
                _t0 = time.perf_counter()
                if len(metas) > 1:
                    arr = arr.reshape(arr.shape[0], -1)
                    for i, (first_num, n) in enumerate(metas):
                        skip = max(0, predictions_after - first_num + 1)
                        writer.write_block(arr[i, :n][skip:])
                else:
                    first_num, n = metas[0]
                    seg = arr.reshape(-1)[:n]
                    skip = max(0, predictions_after - first_num + 1)
                    writer.write_block(seg[skip:])
                ctr["write_s"] += time.perf_counter() - _t0
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            _werr.append(e)
            while _wq.get() is not None:  # unblock the producer
                pass
        finally:
            ctr.setdefault("cpu_s_by_thread", {})["writer"] = (
                time.thread_time() - _cpu0)

    _wt = _threading.Thread(target=_pred_writer, daemon=True)
    _wt.start()

    def _finish_writes() -> None:
        _wq.put(None)
        _wt.join()
        if _werr:
            raise _werr[0]

    def process(params, bd, n, placed=False):
        """One padded batch: train-or-predict, write predictions.

        Batches never span the train/holdout boundary (the producers cut
        there), so the update flag is uniform per batch. ``placed`` means the
        batch is already device-resident (the transfer pipeline stage did
        it) and must not be re-sharded."""
        nonlocal delayed_examples, example_num
        first_num = example_num + 1
        example_num += n
        update = not testonly and (holdout_after is None or first_num < holdout_after)
        if shard_batch_fn is not None and not placed:
            bd = shard_batch_fn(bd)

        _t1 = time.perf_counter()
        if delay == 0:
            if update and train_step is not None:
                params, preds = call_train(params, bd)
            else:
                preds = predict_step(params, bd)
            ctr["dispatch_s"] += time.perf_counter() - _t1
        else:
            # predict with the lagging model, then train queued batches.
            # NOTE: the reference's delay path trains every delayed example
            # (holdout_after is not consulted there) — only --testonly gates
            # (reference: src/main.rs:249-258)
            preds = predict_step(params, bd)
            delayed.append((bd, n))
            delayed_examples += n
            while delayed and delayed_examples - delayed[0][1] >= delay:
                old_bd, old_n = delayed.pop(0)
                delayed_examples -= old_n
                if train_step is not None:
                    params, _ = call_train(params, old_bd)

        if writer.active:
            if not getattr(preds, "is_fully_addressable", True):
                # multi-host: shards live on other processes' devices.
                # Gather ON THIS (main) thread — collectives must be issued
                # in one global order, so the writer thread cannot do it —
                # then every process writes the full prediction stream.
                from jax.experimental import multihost_utils

                preds = multihost_utils.process_allgather(preds, tiled=True)
            elif hasattr(preds, "copy_to_host_async"):
                preds.copy_to_host_async()  # overlap D2H with host work
            _t1 = time.perf_counter()
            _wq.put((preds, [(first_num, n)]))  # blocks when pipeline is full
            ctr["writer_stall_s"] += time.perf_counter() - _t1
        if _werr:
            raise _werr[0]
        return params

    # blocks must end at the train/holdout boundary
    cut_at = holdout_after - 1 if holdout_after is not None else None

    count_keys = host_count_keys(model)

    if _use_native(args, mi):
        import queue
        import threading

        import jax

        from . import packed as packed_mod

        if jax.process_count() > 1:
            # multi-host: feed the stream synchronously on the main thread.
            # Every process must enqueue the same cross-process executions
            # in the same order; the run-ahead transfer thread interleaves
            # device_put/execute differently per process and wedges the
            # CPU collective client (measured: 8 steps never complete,
            # while this path finishes in seconds). Multi-host throughput
            # comes from scale-out, not single-host pipelining.
            for bd, n in native_batch_stream(args, mi, vw, batch_size,
                                             cut_at, count_keys):
                params = process(params, bd, n)
            return finish_run(params)

        # three-stage pipeline: C++ ingest, host→device transfer, and step
        # dispatch each on their own thread. Both ingest and device_put
        # release the GIL, so the transfer overlaps dispatch+drain on the
        # consumer instead of serializing with it.
        #
        # Superbatching (train/packed.py): K consecutive full train batches
        # pack into ONE u32 buffer = one device_put (each leaf of a batch
        # dict is otherwise its own transfer), one scanned dispatch, one
        # [K, B] prediction fetch. Trajectory is
        # identical to K separate steps. Groups never span the
        # train/holdout boundary; partial/tail batches go unpacked.
        K = int(getattr(args, "fwt_superbatch", 0) or 0)
        if K <= 0:
            K = 8
        can_pack = (K > 1 and shard_batch_fn is None and delay == 0
                    and not testonly and train_step is not None)

        q: queue.Queue = queue.Queue(maxsize=3)
        q2: queue.Queue = queue.Queue(maxsize=3)

        bitpack_on = (getattr(args, "fwt_bitpack", "auto") or "auto") != "off"
        # vocabulary-encoded transfer (packed.py encode_vocab_ids): the
        # producer owns the persistent per-column dictionaries; a full
        # device snapshot rides the queue ahead of any group that grew them
        vocab_state = (
            packed_mod.VocabTransferState()
            if bitpack_on
            and (getattr(args, "fwt_vocab", "auto") or "auto") != "off"
            else None)

        # pack cache (train/pack_cache.py): record the producer's queue
        # stream on the first pass, replay it on re-runs over the same
        # input+config — multipass/epoch re-reads skip parse, translate,
        # fill, counts, vocab encoding, and packing. auto = engage with -c
        # (the sibling record cache's own trigger).
        pc_mode = (getattr(args, "fwt_pack_cache", "auto") or "auto")
        pack_iter = None
        pack_writer = None
        if can_pack and pc_mode != "off" and os.path.isfile(args.data) and (
                pc_mode == "on" or bool(getattr(args, "cache", False))):
            from . import pack_cache as pcache

            ppath = pcache.pack_cache_path_for(args.data)
            psig = pcache.stream_signature(
                mi, vw, batch_size=batch_size, K=K, bitpack_on=bitpack_on,
                vocab_on=vocab_state is not None, count_keys=count_keys,
                cut_at=cut_at, data_path=args.data)
            pack_iter = pcache.open_pack_cache(ppath, psig)
            if pack_iter is not None:
                log.info("using pack cache %s", ppath)
            else:
                try:
                    pack_writer = pcache.PackCacheWriter(ppath, psig)
                except OSError as e:
                    log.warning("pack cache disabled (%s)", e)

        # the producer (C++ ingest → slim → superbatch pack, adaptive vocab
        # flip, pack-cache recording) and the transferrer live in
        # train/producer.py — unit-testable without the CLI
        from .producer import SuperbatchProducer, run_transferrer

        _xfer_stats = {"starve_s": 0.0, "xfer_s": 0.0, "put_s": 0.0,
                       "bytes": 0}
        _sbp = SuperbatchProducer(
            args, mi, vw, batch_size=batch_size, K=K, can_pack=can_pack,
            count_keys=count_keys, cut_at=cut_at,
            holdout_after=holdout_after, out_queue=q, ctr=ctr,
            xfer_stats=_xfer_stats, vocab_state=vocab_state,
            pack_iter=pack_iter, pack_writer=pack_writer,
            bitpack_on=bitpack_on)

        _prod_t = threading.Thread(target=_sbp.run, daemon=True)
        _xfer_t = threading.Thread(
            target=run_transferrer, args=(q, q2, ctr, _xfer_stats),
            kwargs={"shard_batch_fn": shard_batch_fn}, daemon=True)
        _prod_t.start()
        _xfer_t.start()

        # fetch-ring (EXPERIMENTAL, default OFF): each packed step writes
        # its [K, B] predictions into row `slot` of a device-resident
        # [M, K, B] ring INSIDE the step program (packed.py
        # make_packed_train_step_ring) and the ring is fetched once per M
        # superbatches — M× fewer D2H fetches with zero extra dispatches,
        # for links where a fetch is slow and holds up the uplink.
        M = int(getattr(args, "fwt_fetch_stack", 0) or 0)
        auto_ring = M == 0 and writer.active
        if M <= 0:
            M = 4 if auto_ring else 1
        use_ring = M > 1 and writer.active and not auto_ring
        # auto (the default): start with per-step async fetches and engage
        # the ring when one prediction copy (timed after block_until_ready,
        # so step compute is not counted) measures slower than
        # FWT_RING_AUTO_MS — a link whose fetches stall. A false engage
        # costs one extra compile; one-way switch.
        ring_auto_ms = float(os.environ.get("FWT_RING_AUTO_MS", "1000"))
        _ring = None          # device [M, K, B] f32
        _ring_metas: list = []  # (first_num, n) per written slot

        def _flush_ring():
            if not _ring_metas:
                return
            if hasattr(_ring, "copy_to_host_async"):
                _ring.copy_to_host_async()
            _t0 = time.perf_counter()
            _wq.put((_ring, list(_ring_metas)))
            ctr["writer_stall_s"] += time.perf_counter() - _t0
            _ring_metas.clear()

        _vocab = None  # device [n_rows, 128] i32 dictionary snapshot

        while True:
            _t0 = time.perf_counter()
            item = q2.get()
            ctr["consumer_starve_s"] += time.perf_counter() - _t0
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            if item[0] == "v":
                _vocab = item[1]
                continue
            if item[0] == "p":
                _, buf, lay, gn = item
                first_num = example_num + 1
                example_num += gn
                kk = int(buf.shape[0])  # K' — short/partial tails pack too
                vargs = (_vocab,) if lay.vocabs else ()
                if auto_ring and not use_ring \
                        and _fetch_stats["last_ms"] > ring_auto_ms:
                    use_ring = True
                    log.info(
                        "prediction fetch measured %.0f ms (> %.0f): "
                        "engaging the device fetch ring (M=%d, one D2H "
                        "per %d superbatches)",
                        _fetch_stats["last_ms"], ring_auto_ms, M, M)
                if use_ring and kk != K:
                    _flush_ring()  # tail: ring slots are [K, B]-shaped
                if use_ring and kk == K:
                    ring_fn = packed_mod.make_packed_train_step_ring(
                        model, lay, K, M)
                    if _ring is None:
                        _ring = jax.device_put(
                            np.zeros((M, K, batch_size), np.float32))
                    _t0 = time.perf_counter()
                    params, _ring = ring_fn(
                        params, buf, _ring, np.int32(len(_ring_metas)),
                        *vargs)
                    ctr["dispatch_s"] += time.perf_counter() - _t0
                    _ring_metas.append((first_num, gn))
                    if len(_ring_metas) == M:
                        _flush_ring()
                else:
                    step_fn = packed_mod.make_packed_train_step(model, lay,
                                                                kk)
                    _t0 = time.perf_counter()
                    params, preds = step_fn(params, buf, *vargs)  # [kk, B]
                    ctr["dispatch_s"] += time.perf_counter() - _t0
                    if writer.active:
                        if hasattr(preds, "copy_to_host_async"):
                            preds.copy_to_host_async()
                        _t0 = time.perf_counter()
                        _wq.put((preds, [(first_num, gn)]))
                        ctr["writer_stall_s"] += time.perf_counter() - _t0
                if _werr:
                    raise _werr[0]
            else:
                _, bd, n = item
                _flush_ring()  # keep the prediction stream in order
                params = process(params, bd, n, placed=True)
        _flush_ring()
        # the producer writes ctr['producer_busy_s'] in its finally block,
        # which can race finish_run's counter snapshot (the consumer can
        # drain the final None before the producer's finally runs) — join
        # both stage threads first
        _prod_t.join(timeout=10.0)
        _xfer_t.join(timeout=10.0)
        if _prod_t.is_alive() or _xfer_t.is_alive():
            # a stage thread outlived its join (e.g. a slow pack_writer
            # flush in the producer's exit path): its finally-block
            # counters (producer_busy_s, cpu_s_by_thread) are not yet
            # written, so mark the snapshot partial — bench.py must not
            # attribute a bottleneck from it (ADVICE r4)
            ctr["counters_partial"] = True
            log.warning(
                "pipeline stage thread still alive after join timeout "
                "(producer=%s transfer=%s); in-run counters are partial",
                _prod_t.is_alive(), _xfer_t.is_alive())
        if vocab_state is not None:
            vocab_state.close()
    else:
        pending: list = []

        def np_counts(ids, vals, shift):
            """NumPy multiplicity counts for the Python-ingest path, coded
            identically to the native engine's (ops/adagrad.encode_counts).
            Entries with value 0 (incl. padding) are excluded — their
            gradient is 0, matching the device path's touched-only counts."""
            from ..ops.adagrad import encode_counts

            keys = ids.astype(np.uint32) >> shift
            real = (vals != 0.0).reshape(-1)
            flat = keys.reshape(-1)
            c = np.zeros(flat.shape, np.int64)
            if real.any():
                u, inv, cnt = np.unique(flat[real], return_inverse=True,
                                        return_counts=True)
                c[real] = cnt[inv]
            return encode_counts(c).reshape(ids.shape)

        def flush(params):
            if not pending:
                return params
            batch = batcher.make_batch(pending)
            bd = _batch_dict(batch)
            if count_keys is not None:
                if "lr" in count_keys:
                    bd["lr_counts"] = np_counts(
                        batch.lr_ids, batch.lr_vals, count_keys["lr"])
                if "ffm" in count_keys and batch.ffm_ids.size:
                    bd["ffm_counts"] = np_counts(
                        batch.ffm_ids, batch.ffm_vals, count_keys["ffm"])
            params = process(params, bd, batch.num_examples)
            pending.clear()
            return params

        seen = 0
        for rec in record_stream(args, vw):
            seen += 1
            pending.append(translator.translate(rec))
            if len(pending) >= batch_size or (cut_at is not None and seen == cut_at):
                params = flush(params)
        params = flush(params)

    # drain the delay queue and the prediction pipeline
    return finish_run(params)


def _daemonize() -> None:
    """Classic double-fork daemonization (the reference daemonizes unless
    --foreground, src/serving.rs:215-225): detach from the controlling
    terminal and session; stdio to /dev/null. Must run before any JAX
    backend initialization."""
    if os.fork() > 0:
        os._exit(0)  # first parent exits; the CLI caller returns
    os.setsid()
    if os.fork() > 0:
        os._exit(0)  # session leader exits; grandchild serves
    devnull = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        try:
            os.dup2(devnull, fd)
        except OSError:
            pass
    os.close(devnull)


def device_startup(args) -> None:
    """First steps of every path that uses the device: place the persistent
    compile cache (utils/compile_cache.py) before the first compile, and
    log which backend and devices the run got. Kept off the
    embedded-engine paths, which must not import jax."""
    from ..utils.logging import log_device_topology

    log.info("compile cache: %s", configure_compile_cache(args) or "off")
    log_device_topology()


def make_serving(args):
    """The daemon's ``Serving`` for ``args`` (``-i`` model, engine choice),
    not yet listening; None after logging why it cannot start.

    ``--fwt_serve_engine auto|native`` starts the C++ engine first: it
    loads the model itself and jax and the device model are never touched
    (about half the memory, reference persistence.rs:159-173, and no
    backend init in the daemon). Only STARTUP failures fall back to the
    device engine."""
    from ..persistence import model_file
    from ..serve.server import Serving

    engine = getattr(args, "fwt_serve_engine", "auto") or "auto"
    if engine in ("auto", "native"):
        try:
            mi, vw = model_file.read_header(args.initial_regressor)
            return Serving(args, mi, vw, None, None,
                           model_path=args.initial_regressor)
        except Exception as e:  # noqa: BLE001
            if engine == "native":
                log.error("native serving engine failed: %s", e)
                return None
            log.warning("native serving unavailable (%s); "
                        "loading the device model", e)
    device_startup(args)
    mi, vw, model, params = model_file.load_model(
        args.initial_regressor, immutable=True, args=args
    )
    return Serving(args, mi, vw, model, params,
                   model_path=args.initial_regressor)


def main(argv=None) -> int:
    import logging

    from ..config.cmdline import build_parser

    args = build_parser().parse_args(argv)

    if getattr(args, "quiet", False):
        logging.getLogger().setLevel(logging.WARNING)

    if getattr(args, "hogwild_training", False):
        log.info(
            "--hogwild_training: asynchronous shared-memory updates map to "
            "synchronous batched data parallelism (SURVEY.md §2.4); "
            "scale throughput with --fwt_batch_size / --fwt_data_axis"
        )

    if getattr(args, "fwt_platform", None):
        import jax

        jax.config.update("jax_platforms", args.fwt_platform)

    # multi-host: must run before any JAX backend initialization
    from ..parallel.distributed import initialize_multihost

    initialize_multihost(
        getattr(args, "fwt_coordinator", None),
        getattr(args, "fwt_hosts", None),
        getattr(args, "fwt_host_id", None),
    )

    if args.final_regressor and not args.save_resume:
        log.error(
            "You need to use --save_resume with --final_regressor,"
            " for vowpal wabbit compatibility"
        )
        return 1

    # -- daemon mode --------------------------------------------------------
    if args.daemon:
        if not args.initial_regressor:
            log.error("Daemon mode only supports serving from --initial_regressor")
            return 1
        if not getattr(args, "foreground", False):
            # detach BEFORE loading the model: forking after a JAX backend
            # (or its client threads) initializes is unsafe
            # (reference daemonizes the same way, src/serving.rs:215-225)
            _daemonize()
        serving = make_serving(args)
        if serving is None:
            return 1
        serving.serve()
        return 0

    # -- convert to inference regressor --------------------------------------
    if args.convert_inference_regressor:
        if not args.initial_regressor:
            log.error("Convert mode requires --initial_regressor")
            return 1
        from ..persistence import model_file

        device_startup(args)
        mi, vw, model, params = model_file.load_model(
            args.initial_regressor, immutable=True, args=args
        )
        if args.weight_quantization:
            mi.dequantize_weights = True
        model_file.save_model(
            args.convert_inference_regressor, mi, vw, model, params,
            quantize_weights=args.weight_quantization,
        )
        return 0

    # -- predict mode on the embedded C++ engine -----------------------------
    if native_predict_eligible(args):
        from .. import native as fw_native

        if fw_native.load() is not None:
            _t_load = time.perf_counter()
            try:
                pred = fw_native.EmbeddedPredictor(
                    f"-i {args.initial_regressor}")
            except RuntimeError as e:
                log.warning("native predict engine unavailable (%s); "
                            "using the device path", e)
            else:
                _t_load = time.perf_counter() - _t_load
                try:
                    _pres = run_native_predict(args, pred)
                    _cpath = os.environ.get("FWT_COUNTERS_OUT")
                    if _cpath:
                        import json

                        # elapsed INCLUDES the model load, matching what
                        # an in-process `-t -i` wall clock measured (the
                        # reference's predict number also pays its load)
                        with open(_cpath, "w") as f:
                            json.dump({"examples": _pres["examples"],
                                       "elapsed": _pres["elapsed"] + _t_load,
                                       "counters": {}}, f)
                    return 0
                except (FlushCommand, HogwildLoadCommand) as e:
                    log.error("Global error: %s", e)
                    return 1

    # -- vwmap + model config -------------------------------------------------
    from ..models.model import FwModel
    from ..persistence import model_file

    device_startup(args)
    if args.initial_regressor:
        from ..parallel import mesh as pmesh

        mi, vw, model, params = model_file.load_model(
            args.initial_regressor, immutable=args.testonly, args=args,
            mesh=pmesh.mesh_from_args(args),
        )
    else:
        if not args.data:
            log.error("--data expected")
            return 1
        vw = VwNamespaceMap.from_dataset_dir(args.data)
        mi = ModelInstance.from_cmdline(args, vw)
        model = FwModel(
            mi,
            batch_mean_mode=getattr(args, "fwt_batch_mean", "auto") or "auto",
            batch_cap=float(getattr(args, "fwt_batch_cap", 8.0) or 8.0),
        )
        params = None

    if args.build_cache_without_training:
        build_cache_without_training(args, vw)
        return 0

    profile_dir = getattr(args, "fwt_profile", None)
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
    try:
        result = run_train_loop(args, mi, vw, model, params)
    except (FlushCommand, HogwildLoadCommand) as e:
        # reference: "Global error: Not really an error: a \"flush\"
        # command from client" → exit(1) (src/main.rs:44-47)
        log.error("Global error: %s", e)
        return 1
    finally:
        if profile_dir:
            import jax

            jax.profiler.stop_trace()
            log.info("profiler trace written to %s", profile_dir)

    if args.final_regressor:
        model_file.save_model(
            args.final_regressor, mi, vw, model, result["params"],
            quantize_weights=bool(args.weight_quantization),
        )

    # FWT_COUNTERS_OUT=<path>: dump the run's in-loop result (examples,
    # elapsed, counters) as JSON — lets bench.py run phases in FRESH
    # subprocesses for RSS isolation while keeping the in-run counter
    # summary (the child's import/compile overhead stays outside the
    # in-loop elapsed)
    cpath = os.environ.get("FWT_COUNTERS_OUT")
    if cpath:
        import json

        try:
            with open(cpath, "w") as f:
                json.dump({"examples": result["examples"],
                           "elapsed": result["elapsed"],
                           "counters": result.get("counters", {})}, f)
        except OSError as e:
            log.warning("FWT_COUNTERS_OUT write failed: %s", e)
    return 0
