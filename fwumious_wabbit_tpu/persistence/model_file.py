"""Model files — the checkpoint *is* the model file, as in the reference.

Byte-level format mirrors the reference
(reference: src/persistence.rs:17-97, src/regressor.rs:426-469):

    b"FWRE" | u32 version=6 LE
    u64 len | namespace-map JSON
    u64 len | ModelInstance JSON
    u64 total weight bytes
    per-block weight bytes, in graph order:
      LR block:  interleaved (weight f32, acc f32) pairs for AdaGrad
                 optimizers, plain f32 weights for SGD
                 (reference: src/block_helpers.rs:17-28 — repr(C)
                 WeightAndOptimizerData)
      FFM block: weights [n]f32 (or 8-byte quantization header + [n]f16
                 bucket ids when quantized), then acc [n]f32 for AdaGrad
                 (reference: src/block_ffm.rs:835-863)
      NN layers: weights [(in+1)·out]f32 laid out neuron-major
                 (w[j·in + i], then biases), then acc same length
                 (reference: src/block_neural.rs:430-448); the final readout
                 neuron is last.

Loading supports the mutable path (weights + optimizer state) and the
immutable/inference path (optimizer state skipped, optimizer forced to SGD —
half the memory, reference: src/persistence.rs:159-173).

`--save_resume` semantics hold: optimizer state is saved inline so training
can resume exactly.
"""

from __future__ import annotations

import io
import os
import struct
from pathlib import Path

import numpy as np

from ..config.model_instance import ModelInstance, Optimizer
from ..config.vwmap import VwNamespaceMap
from . import quantization

# models.model (FwModel) imports jax and is imported lazily in the
# functions that build models — read_header() and this module's import
# must stay jax-free for the native-engine serving/predict cold path

MAGIC = b"FWRE"
VERSION = 6


def _write_chunk(fh, data: bytes) -> None:
    fh.write(struct.pack("<Q", len(data)))
    fh.write(data)


def _read_chunk(fh) -> bytes:
    (n,) = struct.unpack("<Q", fh.read(8))
    return fh.read(n)


def _np(params, key):
    return np.asarray(params[key], np.float32)


def _nn_layer_bytes(layer, with_state: bool) -> bytes:
    """Layer dict {'w': [in,out], 'b': [out], ...} → reference layout bytes."""
    w = np.asarray(layer["w"], np.float32)
    b = np.asarray(layer["b"], np.float32)
    flat = np.concatenate([w.T.ravel(), b])  # neuron-major weights, then biases
    out = flat.tobytes()
    if with_state:
        wa = np.asarray(layer["w_acc"], np.float32)
        ba = np.asarray(layer["b_acc"], np.float32)
        out += np.concatenate([wa.T.ravel(), ba]).tobytes()
    return out


def _nn_layer_from_bytes(fh, fan_in: int, fan_out: int, with_state: bool,
                         load_state: bool) -> dict:
    n = (fan_in + 1) * fan_out
    flat = np.frombuffer(fh.read(4 * n), np.float32)
    w = flat[: fan_in * fan_out].reshape(fan_out, fan_in).T.copy()
    b = flat[fan_in * fan_out :].copy()
    layer = {"w": w, "b": b}
    if with_state:
        acc = np.frombuffer(fh.read(4 * n), np.float32)
        if load_state:
            layer["w_acc"] = acc[: fan_in * fan_out].reshape(fan_out, fan_in).T.copy()
            layer["b_acc"] = acc[fan_in * fan_out :].copy()
    return layer


def _fetch_global(params):
    """Make every param leaf host-fetchable. In a multi-host run
    (parallel/distributed.py) table shards live on other processes'
    devices; process_allgather assembles the global arrays on every host so
    checkpointing works from any process (the reference is single-machine —
    net-new, SURVEY §2.4)."""
    import jax

    if jax.process_count() <= 1:
        return params
    from jax.experimental import multihost_utils

    def fetch(x):
        if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
            return multihost_utils.process_allgather(x, tiled=True)
        return x

    return jax.tree.map(fetch, params,
                        is_leaf=lambda x: not isinstance(x, (dict, list)))


def save_model(
    path: str | Path,
    mi: ModelInstance,
    vw: VwNamespaceMap,
    model: FwModel,
    params,
    quantize_weights: bool = False,
) -> None:
    params = _fetch_global(params)
    # write to a sibling temp and rename on completion: a killed process
    # must never leave a truncated model at the final path (same atomic
    # discipline as the record cache, reference src/cache.rs:147-153;
    # also what makes hogwild_load hot swaps safe against concurrent
    # writers — the serving host only ever sees complete files)
    tmp = str(path) + ".writing"
    with open(tmp, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<I", VERSION))
        _write_chunk(fh, vw.to_source_json().encode())
        _write_chunk(fh, mi.to_json().encode())

        # Sizes are computed analytically and blocks STREAMED to the file
        # (chunked interleave + ndarray.tofile): the old accumulate-then-
        # write built a full interleaved temp plus a tobytes() copy per
        # block — ~800 MB transient for a b=25 model, the single biggest
        # RSS spike in bench.py's phase decomposition.
        has_state = model.opt_lr.has_state
        lr_w = _np(params, "lr_w").reshape(-1)[: model.lr_size]
        lr_acc = (_np(params, "lr_acc").reshape(-1)[: model.lr_size]
                  if has_state else None)
        ffm_w = ffm_acc = ffm_q = None
        if model.has_ffm:
            ffm_w = _np(params, "ffm_w").reshape(-1)[: model.ffm_size]
            if quantize_weights:
                ffm_q = quantization.quantize_ffm_weights(ffm_w)
            if model.opt_ffm.has_state:
                ffm_acc = _np(params, "ffm_acc").reshape(-1)[: model.ffm_size]
        nn_blocks: list[bytes] = []
        if model.has_nn:
            for layer in params["nn"]:
                nn_blocks.append(_nn_layer_bytes(layer, model.opt_nn.has_state))
            nn_blocks.append(_nn_layer_bytes(params["final"],
                                             model.opt_nn.has_state))

        total = int(lr_w.nbytes) * (2 if has_state else 1)
        if model.has_ffm:
            total += len(ffm_q) if ffm_q is not None else int(ffm_w.nbytes)
            if ffm_acc is not None:
                total += int(ffm_acc.nbytes)
        total += sum(len(b) for b in nn_blocks)
        fh.write(struct.pack("<Q", total))

        if has_state:
            # LR block: interleaved weight/acc pairs (row tables flattened
            # back to the reference's flat arena layout), 4M-element chunks
            CH = 4 << 20
            buf = np.empty(2 * CH, np.float32)
            for off in range(0, lr_w.size, CH):
                m = min(CH, lr_w.size - off)
                t = buf[: 2 * m]
                t[0::2] = lr_w[off:off + m]
                t[1::2] = lr_acc[off:off + m]
                t.tofile(fh)
        else:
            np.ascontiguousarray(lr_w).tofile(fh)
        if model.has_ffm:
            if ffm_q is not None:
                fh.write(ffm_q)
            else:
                np.ascontiguousarray(ffm_w).tofile(fh)
            if ffm_acc is not None:
                np.ascontiguousarray(ffm_acc).tofile(fh)
        for b in nn_blocks:
            fh.write(b)
    os.replace(tmp, path)


def load_model(
    path: str | Path,
    immutable: bool = False,
    args=None,
    mesh=None,
):
    """Returns (mi, vw, model, params).

    ``immutable=True`` loads weights only (no optimizer state) and converts
    the config to SGD — the serving/inference path
    (reference: src/persistence.rs:127-174). With a ``mesh``, the params
    go from the host straight to their shardings on it
    (parallel/mesh.py), each device receiving only its shard."""
    with open(path, "rb") as fh:
        mi, vw = _read_header_fh(fh)
        if args is not None:
            mi.update_hyperparameters_from_cmd(args)
        (_total,) = struct.unpack("<Q", fh.read(8))

        dequantize = bool(mi.dequantize_weights) and not (
            args is not None and getattr(args, "convert_inference_regressor", None)
        )

        from ..models.model import FwModel

        saved_model = FwModel(mi)  # structure as saved (for state layout)
        has_state = saved_model.opt_lr.has_state
        params = {}

        lr_n = saved_model.lr_size
        if has_state:
            lr = np.frombuffer(fh.read(8 * lr_n), np.float32)
            params["lr_w"] = lr[0::2].copy()
            if not immutable:
                params["lr_acc"] = lr[1::2].copy()
        else:
            params["lr_w"] = np.frombuffer(fh.read(4 * lr_n), np.float32).copy()

        if saved_model.has_ffm:
            n = saved_model.ffm_size
            if dequantize:
                data = fh.read(quantization.quantized_size(n))
                params["ffm_w"] = quantization.dequantize_ffm_weights(data, n)
            else:
                params["ffm_w"] = np.frombuffer(fh.read(4 * n), np.float32).copy()
            if saved_model.opt_ffm.has_state:
                acc = fh.read(4 * n)
                if not immutable:
                    params["ffm_acc"] = np.frombuffer(acc, np.float32).copy()

        if saved_model.has_nn:
            layers = []
            d = saved_model.joined_width
            for spec in saved_model.nn_layers:
                layers.append(
                    _nn_layer_from_bytes(fh, d, spec.width,
                                         saved_model.opt_nn.has_state, not immutable)
                )
                d = spec.width
            params["nn"] = layers
            final_in = d + (saved_model.joined_width
                            if saved_model.topology != "two" else 0)
            params["final"] = _nn_layer_from_bytes(
                fh, final_in, 1, saved_model.opt_nn.has_state, not immutable
            )

    if immutable:
        mi.optimizer = Optimizer.SGD
    from ..models.model import FwModel

    model = FwModel(
        mi,
        batch_mean_mode=(getattr(args, "fwt_batch_mean", "auto") or "auto")
        if args is not None else "auto",
        batch_cap=float(getattr(args, "fwt_batch_cap", 8.0) or 8.0)
        if args is not None else 8.0,
    )
    import jax
    import jax.numpy as jnp

    from ..ops import tables
    from ..parallel import mesh as pmesh

    def _lift(k, v):
        if k in ("lr_w", "lr_acc"):
            spec = model.lr_spec
        elif k in ("ffm_w", "ffm_acc"):
            spec = model.ffm_spec
        else:
            return v
        # [rows, 128] on the host, zero past the saved floats
        n_rows = pmesh.table_rows(spec.num_rows, mesh)
        if v.size == n_rows * tables.LANE:
            return v.reshape(n_rows, tables.LANE)
        rows = np.zeros((n_rows, tables.LANE), np.float32)
        rows.reshape(-1)[: v.size] = v
        return rows

    params = {k: _lift(k, v) for k, v in params.items()}
    if mesh is not None:
        return mi, vw, model, pmesh.shard_params(
            params, pmesh.param_sharding(mesh, params))
    return mi, vw, model, jax.tree.map(jnp.asarray, params)


def _read_header_fh(fh):
    """Magic/version check + the two embedded config JSONs; leaves ``fh``
    positioned at the weights total. Shared by load_model and
    read_header so a header change lands in exactly one place."""
    magic = fh.read(4)
    if magic != MAGIC:
        raise ValueError("Model file does not begin with magic bytes FWRE")
    (version,) = struct.unpack("<I", fh.read(4))
    if version != VERSION:
        raise ValueError(
            f"Model file version of this binary: {VERSION}, version of the file: {version}"
        )
    vw = VwNamespaceMap.from_source_json(_read_chunk(fh).decode())
    mi = ModelInstance.from_json(_read_chunk(fh).decode())
    return mi, vw


def read_header(path: str | Path):
    """Read only the embedded (vwmap, model-instance) configs — no
    weights, no jax (the native-engine serving path needs the namespace
    map for parse-error replies without loading the device model)."""
    with open(path, "rb") as fh:
        return _read_header_fh(fh)


def hogwild_load(path: str | Path, model: "FwModel", immutable: bool):
    """Hot-swap weights from a model file into a running configuration
    (reference: src/persistence.rs:176-186). Returns new params."""
    _mi, _vw, _model, params = load_model(path, immutable=immutable)
    return params
