"""The jitted train/predict steps.

One step = forward + backward + AdaGrad update for a whole padded batch,
compiled by XLA into a single device program (this replaces the reference's
per-example recursive block sweep, reference: src/regressor.rs:356-379,
src/block_helpers.rs:218-273).

Gradient architecture:

* the **sparse half** (LR gather/segment-sum + FFM contra-tensor math) gets
  its cotangents from ``jax.vjp`` — autodiff through the contra formulation
  reproduces the reference's hand-written FFM backward exactly (verified in
  tests against golden values);
* the **dense tower** is backpropagated manually so that per-weight
  ``Σ_examples g²`` (the AdaGrad accumulator bump the reference applies per
  example, reference: src/block_neural.rs:266-305) is available as
  ``(x²)ᵀ(δ²)`` without materializing per-example weight gradients.

The returned predictions are the *training-path* forward values (the
reference's ``learn()`` returns the pre-update forward prediction,
reference: src/regressor.rs:356-379).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.model import FwModel, normalize_predict, predict_prob
from ..utils.logging import get_logger

log = get_logger(__name__)


def _tower_forward(model: FwModel, dense, x, train: bool):
    """Forward through the dense tower keeping residuals for manual backward.

    Returns (logit [B], residuals).
    """
    topo = model.topology
    sigma0 = None
    if topo == "one":
        t, joined = x, x
    elif topo == "two":
        t, joined = x, None
    elif topo == "four":
        if train:
            mean = jnp.mean(x, axis=-1, keepdims=True)
            w = mean * mean - x
            var = (jnp.sum(w * w, axis=-1, keepdims=True) + 1e-2) / x.shape[-1]
            sigma0 = jnp.sqrt(var)
            t = (x - mean) / sigma0
        else:
            t = normalize_predict(x)
        joined = x
    elif topo == "five":
        t, joined = jax.lax.stop_gradient(x), x
    else:
        raise ValueError(f'unknown nn topology: "{topo}"')

    acts = []  # per layer: (input, pre_norm_sigma?, relu_mask?, post_norm_sigma?)
    for spec, layer in zip(model.nn_layers, dense["nn"]):
        inp = t
        t = jnp.dot(t, layer["w"], precision=model.precision) + layer["b"]
        sig_b = None
        if spec.layernorm == "before":
            mean = jnp.mean(t, axis=-1, keepdims=True)
            w = mean * mean - t
            var = (jnp.sum(w * w, axis=-1, keepdims=True) + 1e-2) / t.shape[-1]
            sig_b = jnp.sqrt(var)
            t = (t - mean) / sig_b if train else t / sig_b  # predict path: x/σ
        mask = None
        if spec.activation == "relu":
            mask = t > 0.0
            t = jnp.where(mask, t, 0.0)
        sig_a = None
        if spec.layernorm == "after":
            mean = jnp.mean(t, axis=-1, keepdims=True)
            w = mean * mean - t
            var = (jnp.sum(w * w, axis=-1, keepdims=True) + 1e-2) / t.shape[-1]
            sig_a = jnp.sqrt(var)
            t = (t - mean) / sig_a if train else t / sig_a
        acts.append((inp, sig_b, mask, sig_a))

    final_in = jnp.concatenate([t, joined], axis=-1) if joined is not None else t
    final = dense["final"]
    logit = (jnp.dot(final_in, final["w"], precision=model.precision) + final["b"])[:, 0]
    residuals = (acts, final_in, sigma0)
    return logit, residuals


def _tower_backward(model: FwModel, dense, residuals, dlogit):
    """Manual backward. Returns (g_x [B,D], grads, gsqs) where grads/gsqs
    mirror the dense pytree {nn: [...], final: {...}}.

    The normalize blocks backprop g/σ (the reference's rule, not the true
    gradient — reference: src/block_normalize.rs:99-105); relu masks; the
    stop-gradient topology passes nothing through the tower to x.
    """
    acts, final_in, sigma0 = residuals
    tower_width = model.nn_layers[-1].width if model.nn_layers else None

    final = dense["final"]
    g_final_in = dlogit[:, None] * final["w"][:, 0][None, :]  # [B, Din]
    g_w_final = jnp.dot(final_in.T, dlogit[:, None], precision=model.precision)  # [Din, 1]
    gsq_w_final = jnp.dot((final_in * final_in).T, (dlogit * dlogit)[:, None], precision=model.precision)
    g_b_final = jnp.sum(dlogit)[None]
    gsq_b_final = jnp.sum(dlogit * dlogit)[None]

    if model.topology != "two":
        g_t = g_final_in[:, :tower_width]
        g_joined = g_final_in[:, tower_width:]
    else:
        g_t, g_joined = g_final_in, None

    nn_grads, nn_gsqs = [], []
    for spec, layer, (inp, sig_b, mask, sig_a) in zip(
        reversed(model.nn_layers), reversed(dense["nn"]), reversed(acts)
    ):
        if sig_a is not None:
            g_t = g_t / sig_a
        if mask is not None:
            g_t = jnp.where(mask, g_t, 0.0)
        if sig_b is not None:
            g_t = g_t / sig_b
        g_w = jnp.dot(inp.T, g_t, precision=model.precision)
        gsq_w = jnp.dot((inp * inp).T, g_t * g_t, precision=model.precision)
        g_b = jnp.sum(g_t, axis=0)
        gsq_b = jnp.sum(g_t * g_t, axis=0)
        nn_grads.append({"w": g_w, "b": g_b})
        nn_gsqs.append({"w": gsq_w, "b": gsq_b})
        g_t = jnp.dot(g_t, layer["w"].T, precision=model.precision)
    nn_grads.reverse()
    nn_gsqs.reverse()

    topo = model.topology
    if topo == "one":
        g_x = g_t + g_joined
    elif topo == "two":
        g_x = g_t
    elif topo == "four":
        g_x = g_t / sigma0 + g_joined
    else:  # five: stop-gradient into the tower
        g_x = g_joined

    grads = {"nn": nn_grads, "final": {"w": g_w_final, "b": g_b_final}}
    gsqs = {"nn": nn_gsqs, "final": {"w": gsq_w_final, "b": gsq_b_final}}
    return g_x, grads, gsqs


def apply_maxnorm(w: jnp.ndarray, maxnorm: float) -> jnp.ndarray:
    """Per-neuron max-norm reprojection: scale each neuron's input-weight
    column back to ``maxnorm`` when its L2 norm exceeds it (reference:
    src/block_neural.rs:307-320 — applied every 10th example there; the
    batched analogue applies once per step)."""
    norms = jnp.sqrt(1e-6 + jnp.sum(w * w, axis=0, keepdims=True))
    scale = jnp.where(norms > maxnorm, maxnorm / norms, 1.0)
    return w * scale


def make_train_step(model: FwModel):
    """Build the jitted train step: (params, batch) → (params, preds).

    Memoized per model — rebuilding the closure would retrace and recompile
    (several seconds per shape)."""
    cached = getattr(model, "_cached_train_step", None)
    if cached is not None:
        return cached

    has_ffm = model.has_ffm
    has_nn = model.has_nn

    def train_step(params, batch):
        lr_wg, lr_aux = model.gather_lr(params, batch)  # [B, L]
        emb, ffm_aux = (
            model.gather_ffm(params, batch) if has_ffm else (None, None)
        )

        def sparse_to_x(lr_wg, emb):
            parts = [model.lr_outputs(lr_wg, batch)]
            if has_ffm:
                parts.append(model.triangle(model.ffm_outputs(emb, batch)))
            return jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]

        if has_ffm:
            x, sparse_vjp = jax.vjp(sparse_to_x, lr_wg, emb)
        else:
            x, sparse_vjp = jax.vjp(lambda lw: sparse_to_x(lw, None), lr_wg)

        if has_nn:
            logit, residuals = _tower_forward(model, params, x, train=True)
        else:
            logit = jnp.sum(x, axis=-1)

        # the reference's general_gradient: (p − label)·importance inside the
        # ±50 clamp, zero outside / NaN (src/block_loss_functions.rs:122-141)
        p = predict_prob(logit)
        # label may arrive as uint8; importance may be elided (all ones)
        gg = p - batch["label"].astype(jnp.float32)
        imp = batch.get("importance")
        if imp is not None:
            gg = gg * imp
        inside = (logit >= -50.0) & (logit <= 50.0) & ~jnp.isnan(logit)
        dlogit = jnp.where(inside, gg, 0.0)

        new_params = dict(params)

        if has_nn:
            g_x, nn_grads, nn_gsqs = _tower_backward(model, params, residuals, dlogit)
            new_nn = []
            for spec, layer, g, q in zip(
                model.nn_layers, params["nn"], nn_grads["nn"], nn_gsqs["nn"]
            ):
                nl = dict(layer)
                nl["w"], w_acc = model.opt_nn.apply_dense(
                    layer["w"], layer.get("w_acc"), g["w"], q["w"]
                )
                nl["b"], b_acc = model.opt_nn.apply_dense(
                    layer["b"], layer.get("b_acc"), g["b"], q["b"]
                )
                if spec.maxnorm > 0.0:
                    nl["w"] = apply_maxnorm(nl["w"], spec.maxnorm)
                if w_acc is not None:
                    nl["w_acc"], nl["b_acc"] = w_acc, b_acc
                new_nn.append(nl)
            new_params["nn"] = new_nn
            fl = dict(params["final"])
            fl["w"], fw_acc = model.opt_nn.apply_dense(
                params["final"]["w"], params["final"].get("w_acc"),
                nn_grads["final"]["w"], nn_gsqs["final"]["w"],
            )
            fl["b"], fb_acc = model.opt_nn.apply_dense(
                params["final"]["b"], params["final"].get("b_acc"),
                nn_grads["final"]["b"], nn_gsqs["final"]["b"],
            )
            if fw_acc is not None:
                fl["w_acc"], fl["b_acc"] = fw_acc, fb_acc
            new_params["final"] = fl
        else:
            g_x = dlogit[:, None] * jnp.ones_like(x)

        if has_ffm:
            g_lr, g_emb = sparse_vjp(g_x)
        else:
            (g_lr,) = sparse_vjp(g_x)

        # sparse row updates: only touched rows move through HBM
        from ..ops import tables

        B = dlogit.shape[0]
        # reference semantics: per example, sum a weight's contributions and
        # update once — acc gets (Σg)², not Σg². Deduping the pre-expansion
        # scalars/slabs costs 128/P× less HBM than deduping [K,128] rows;
        # batch_mean keeps the row-level path so its per-row multiplicity
        # counts are unchanged.
        # host-precomputed multiplicity counts (loop.native_batch_stream):
        # the batch-mean cap factor is a function of the entry's ID alone,
        # so it applies to the PRE-EXPANSION scalars — every occurrence of
        # a weight carries the same factor, making scale-then-dedup-sum
        # the same cap as sum-then-scale, at [B, L] cost instead of
        # [B·L, 128] (opt.count_factor) and with no rid↔counts positional
        # alignment requirement
        lr_counts = batch.get("lr_counts")
        lr_pre_scaled = False
        if model.opt_lr.batch_mean and lr_counts is not None:
            g_lr = g_lr * model.opt_lr.count_factor(lr_counts)
            lr_pre_scaled = True
        if model.opt_lr.has_state and (not model.opt_lr.batch_mean
                                       or lr_pre_scaled):
            # pre-scaling freed the batch-mean path to use the cheap
            # pre-expansion dedup as well (scalars, not [K,128] rows —
            # measured ~20 ms of a 263 ms LR superbatch)
            lr_ids, _ = model.lr_ids_combos(batch)
            rid_lr, grows_lr = tables.expand_scalar_grads_dedup(lr_ids, g_lr)
        else:
            rid_lr, grows_lr = tables.expand_scalar_grads(lr_aux, g_lr)
            if model.opt_lr.has_state:
                # merge keyed by the feature id (not the row): merging two
                # same-row different-lane entries is unnecessary (disjoint
                # lanes — the scatter is elementwise) and same-key entries
                # must sum for the (Σg)² accumulator semantics
                lr_ids, _ = model.lr_ids_combos(batch)
                rid_lr, grows_lr = tables.dedup_rows(
                    rid_lr, grows_lr, B, keys=lr_ids)
        new_params["lr_w"], lr_acc = model.opt_lr.apply_rows(
            params["lr_w"], params.get("lr_acc"), rid_lr, grows_lr,
            pre_scaled=lr_pre_scaled,
        )
        if lr_acc is not None:
            new_params["lr_acc"] = lr_acc

        if has_ffm:
            # pre-expansion batch-mean scaling, as for LR: the window-keyed
            # factor broadcasts over the slab axis of g_emb. Works for any
            # rows_per_slab (the old positionally-aligned counts path was
            # limited to single-row slabs and order-preserving dedup).
            ffm_counts = batch.get("ffm_counts")
            ffm_pre_scaled = False
            if model.opt_ffm.batch_mean and ffm_counts is not None:
                f = model.opt_ffm.count_factor(ffm_counts)
                g_emb = g_emb * f.reshape(
                    *ffm_counts.shape, *([1] * (g_emb.ndim - ffm_counts.ndim))
                )
                ffm_pre_scaled = True
            if (model.opt_ffm.has_state
                    and (not model.opt_ffm.batch_mean or ffm_pre_scaled)
                    and model.ffm_spec.rows_per_slab == 1):
                rid_ffm, grows_ffm = tables.expand_grads_dedup(
                    batch["ffm_ids"], g_emb, model.ffm_spec
                )
            else:
                rid_ffm, grows_ffm = tables.expand_grads(ffm_aux, g_emb, model.ffm_spec)
                if model.opt_ffm.has_state:
                    # merge keyed by the window id: same-row different-
                    # window entries occupy disjoint lanes and need no
                    # merge; same-window entries sum for (Σg)² semantics
                    keys = None
                    if model.ffm_spec.rows_per_slab == 1:
                        pos_bits = (model.ffm_spec.align - 1).bit_length()
                        keys = jax.lax.shift_right_logical(
                            batch["ffm_ids"], pos_bits)
                    rid_ffm, grows_ffm = tables.dedup_rows(
                        rid_ffm, grows_ffm, B, keys=keys)
            new_params["ffm_w"], ffm_acc = model.opt_ffm.apply_rows(
                params["ffm_w"], params.get("ffm_acc"), rid_ffm, grows_ffm,
                pre_scaled=ffm_pre_scaled,
            )
            if ffm_acc is not None:
                new_params["ffm_acc"] = ffm_acc

        return new_params, p

    model._train_step_raw = train_step  # unjitted body (train/packed.py
    # scans it over a superbatch inside one jit)
    jitted = jax.jit(train_step, donate_argnums=(0,))
    model._cached_train_step = jitted
    return jitted


def make_predict_step(model: FwModel):
    cached = getattr(model, "_cached_predict_step", None)
    if cached is not None:
        return cached

    def predict_step(params, batch):
        return model.predict(params, batch)

    jitted = jax.jit(predict_step)
    model._cached_predict_step = jitted
    return jitted
