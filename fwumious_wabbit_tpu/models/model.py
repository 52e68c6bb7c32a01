"""The model: hashed LR ⊕ field-aware FM (triangle) → optional dense tower →
clamped sigmoid logloss — as one batched, jittable JAX program.

This replaces the reference's block/tape architecture (reference:
src/regressor.rs:173-330, src/graph.rs): there is no tape — XLA fuses the
whole step — but the math is the same:

* **LR** (reference: src/block_lr.rs:28-47): per-feature gather
  ``out[combo] += w[hash]·value``; one output per feature combo (+1 bias).
* **FFM** (reference: src/block_ffm.rs:122-314): with the contra tensor
  ``C[b,t,f,k] = Σ_{a∈field f} v_a · w_a→t[k]`` the reference's
  field-pair outputs are
  ``out[t,f] = 0.5·(⟨C[t,f,:],C[f,t,:]⟩ − [t==f]·Σ_{a∈t} v_a²‖w_a→t‖²)``
  (self-interactions subtracted on the diagonal, 0.5 factors as in
  block_ffm.rs:236-257,416-424). Embeddings live in a flat table; feature
  hash h owns the F·k consecutive floats at w[h..] (hashes are masked so the
  low ceil(log2 k) bits are free — src/feature_buffer.rs:141-148).
* **Triangle** (reference: src/block_misc.rs:736-884): row-major lower
  triangle, off-diagonal ×2, diagonal ×1.
* **NN tower** (reference: src/regressor.rs:191-320, src/block_neural.rs):
  topologies one/two/four/five (copy-split residual, optional
  normalize/stop-gradient), per-layer width/relu/layernorm(before|after),
  final 1-neuron readout initialized to ones.
* **Loss** (reference: src/block_loss_functions.rs:105-153): logit clamped
  to ±50 (gradient zeroed outside), NaN → 0.5, gradient
  ``-(label − p)·importance``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..config.model_instance import ModelInstance, Optimizer
from ..ops import tables
from ..ops.adagrad import (
    OPT_ADAGRAD_FLEX,
    OPT_ADAGRAD_LUT,
    OPT_SGD,
    ScopedOptimizer,
)

_OPT_KIND = {
    Optimizer.SGD: OPT_SGD,
    Optimizer.ADAGRAD_FLEX: OPT_ADAGRAD_FLEX,
    Optimizer.ADAGRAD_LUT: OPT_ADAGRAD_LUT,
}


# ---------------------------------------------------------------------------
# loss head with the reference's exact gradient semantics
# ---------------------------------------------------------------------------


def predict_prob(logit: jnp.ndarray) -> jnp.ndarray:
    """sigmoid(clamp(logit, ±50)); NaN → 0.5
    (reference: src/block_loss_functions.rs:59-72)."""
    p = jax.nn.sigmoid(jnp.clip(logit, -50.0, 50.0))
    return jnp.where(jnp.isnan(logit), 0.5, p)


@jax.custom_vjp
def clamped_logloss(logit, label, importance):
    """Importance-weighted logloss whose gradient w.r.t. logit is exactly the
    reference's ``general_gradient``: ``(p − label)·importance`` inside the
    ±50 clamp, 0 outside or on NaN (reference:
    src/block_loss_functions.rs:122-141). Returns the summed loss."""
    p = predict_prob(logit)
    eps = 1e-12
    ce = -(label * jnp.log(p + eps) + (1.0 - label) * jnp.log(1.0 - p + eps))
    return jnp.sum(ce * importance)


def _clamped_logloss_fwd(logit, label, importance):
    return clamped_logloss(logit, label, importance), (logit, label, importance)


def _clamped_logloss_bwd(res, g):
    logit, label, importance = res
    p = predict_prob(logit)
    gg = (p - label) * importance
    inside = (logit >= -50.0) & (logit <= 50.0) & ~jnp.isnan(logit)
    gg = jnp.where(inside, gg, 0.0)
    return (g * gg, jnp.zeros_like(label), jnp.zeros_like(importance))


clamped_logloss.defvjp(_clamped_logloss_fwd, _clamped_logloss_bwd)


# ---------------------------------------------------------------------------
# normalize block with the reference's (non-true-gradient) backward
# ---------------------------------------------------------------------------

_NORM_EPS = 1e-2  # reference: src/block_normalize.rs:15


def _norm_stats(x):
    n = x.shape[-1]
    mean = jnp.mean(x, axis=-1, keepdims=True)
    # the reference's quirky variance: mean over (mean² − x)², EPS added
    # before the division (reference: src/block_normalize.rs:77-92)
    w = mean * mean - x
    var = (jnp.sum(w * w, axis=-1, keepdims=True) + _NORM_EPS) / n
    return mean, jnp.sqrt(var)


@jax.custom_vjp
def normalize_train(x):
    mean, sigma = _norm_stats(x)
    return (x - mean) / sigma


def _normalize_train_fwd(x):
    mean, sigma = _norm_stats(x)
    return (x - mean) / sigma, sigma


def _normalize_train_bwd(sigma, g):
    # the reference backprops g/σ, treating mean and σ as constants
    # (reference: src/block_normalize.rs:99-105)
    return (g / sigma,)


normalize_train.defvjp(_normalize_train_fwd, _normalize_train_bwd)


def normalize_predict(x):
    """Prediction path normalizes without mean subtraction
    (reference: src/block_normalize.rs:130-163)."""
    _, sigma = _norm_stats(x)
    return x / sigma


# ---------------------------------------------------------------------------
# layer config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NNLayerSpec:
    width: int
    activation: str  # 'none' | 'relu'
    layernorm: str  # 'none' | 'before' | 'after'
    maxnorm: float
    init: str  # 'xavier' | 'hu' | 'one' | 'zero'


def _parse_nn_layers(mi: ModelInstance) -> list[NNLayerSpec]:
    specs = []
    for layer_num, layer in enumerate(mi.nn_config.layers):
        layer = dict(layer)
        activation = layer.pop("activation", "none")
        layernorm = layer.pop("layernorm", "none")
        width = int(layer.pop("width", "20"))
        maxnorm = float(layer.pop("maxnorm", "0.0"))
        dropout = float(layer.pop("dropout", "0.0"))
        init = layer.pop("init", "hu")
        if layer:
            raise ValueError(f"Unknown --nn parameter for layer number {layer_num}: {layer}")
        if dropout != 0.0:
            # reference: src/block_neural.rs:82-84 — dropout is hard-disabled
            raise ValueError("Dropout is not supported (disabled in the reference as well)")
        if activation not in ("none", "relu"):
            raise ValueError(f'unknown nn activation type: "{activation}"')
        if layernorm not in ("none", "before", "after"):
            raise ValueError(f'unknown nn layer norm: "{layernorm}"')
        if init not in ("xavier", "hu", "one", "zero"):
            raise ValueError(f'unknown nn initialization type: "{init}"')
        specs.append(NNLayerSpec(width, activation, layernorm, maxnorm, init))
    return specs


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class FwModel:
    """Static model structure + parameter init + forward math.

    Parameters are a plain dict pytree. The hashed tables are stored in the
    **row layout** ``[num_rows, 128]`` (see ops/tables.py):
      lr_w [R_lr, 128], lr_acc [R_lr, 128]?,
      ffm_w [R_ffm, 128], ffm_acc?,
      nn: list of {'w': [in,out] f32, 'b': [out], 'w_acc'?, 'b_acc'?},
      final: same shape dict (1-neuron readout) when a tower is configured.
    Persistence flattens rows back to the reference's flat arenas.
    """

    def __init__(self, mi: ModelInstance, precision: str = "highest",
                 batch_mean_mode: str = "auto", batch_cap: float = 8.0):
        # precision of the model's dense contractions (FFM contra tensor,
        # LR combo sums, tower): 'highest' = full f32 (parity with the f32
        # reference); 'default' = TF32 tensor-core inputs on the GPU, ~10
        # mantissa bits (throughput mode; statistical parity only). The
        # table selections and dedup sums (ops/tables.py) are exact either way.
        #
        # batch_mean_mode ('off'|'on'|'auto', --fwt_batch_mean): cap each
        # weight's effective per-batch multiplicity at batch_cap
        # (ops/adagrad.batch_mean_grads — weights with ≤ cap contributing
        # examples are untouched; hotter weights' summed gradients are
        # scaled to cap online-updates' worth, which is what keeps the
        # constant-rate power_t-0 configs from diverging at large batch).
        # 'auto' enables it exactly where the summed form is unstable —
        # AdaGrad scopes with power_t == 0, whose rate is a constant lr with
        # no accumulator self-stabilization (the reference's own benchmark
        # config, BENCHMARK.md: --adaptive --power_t 0.0). Identical at
        # batch size 1 in every mode, so --fwt_exact parity is unaffected;
        # --sgd configs are never touched by 'auto' (the bit-parity mode).
        self.precision = (
            jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
        )
        self.mi = mi
        self.num_combos = mi.num_combos
        self.num_fields = mi.num_ffm_fields
        self.ffm_k = mi.ffm_k
        self.has_ffm = mi.ffm_k > 0 and self.num_fields > 0
        self.lr_size = 1 << mi.bit_precision
        self.ffm_size = mi.ffm_weights_len
        self.lr_spec = tables.make_spec(self.lr_size, 1)
        self.ffm_spec = (
            tables.make_spec(self.ffm_size, self.num_fields * self.ffm_k)
            if self.has_ffm
            else None
        )
        self.nn_layers = _parse_nn_layers(mi)
        self.has_nn = len(self.nn_layers) > 0
        self.topology = mi.nn_config.topology

        kind = _OPT_KIND[mi.optimizer]

        def bm(power_t: float) -> bool:
            if batch_mean_mode == "on":
                return True
            return (batch_mean_mode == "auto" and kind != OPT_SGD
                    and float(power_t) == 0.0)

        self.opt_lr = ScopedOptimizer(kind, mi.learning_rate, mi.power_t,
                                      mi.init_acc_gradient,
                                      batch_mean=bm(mi.power_t),
                                      batch_cap=batch_cap)
        self.opt_ffm = ScopedOptimizer(
            kind, mi.ffm_learning_rate, mi.ffm_power_t, mi.ffm_init_acc_gradient,
            batch_mean=bm(mi.ffm_power_t), batch_cap=batch_cap,
        )
        self.opt_nn = ScopedOptimizer(
            kind, mi.nn_learning_rate, mi.nn_power_t, mi.nn_init_acc_gradient
        )

        F = self.num_fields
        tri_i, tri_j, tri_scale = [], [], []
        for i in range(F):
            for j in range(i):
                tri_i.append(i)
                tri_j.append(j)
                tri_scale.append(2.0)
            tri_i.append(i)
            tri_j.append(i)
            tri_scale.append(1.0)
        self._tri_i = np.asarray(tri_i, np.int32)
        self._tri_j = np.asarray(tri_j, np.int32)
        self._tri_scale = np.asarray(tri_scale, np.float32)
        self.tri_width = len(tri_i)

        # width of the vector entering the tower / terminal sum
        self.joined_width = self.num_combos + (self.tri_width if self.has_ffm else 0)

    # -- init ----------------------------------------------------------------

    def init_params(self, seed: int = 0, mesh=None) -> dict:
        """Fresh parameters. With a ``mesh`` ('data', 'table'), every table
        is built already row-sharded over the table axis (its rows rounded
        up to a multiple of that axis; rows past the hash range are never
        addressed): no device ever holds a whole table, and the rest is
        replicated."""
        if mesh is None:
            params = self._init_tables(1)
        else:
            from ..parallel import mesh as pmesh

            n_table = mesh.shape[pmesh.TABLE_AXIS]
            build = functools.partial(self._init_tables, n_table)
            params = jax.jit(build, out_shardings=pmesh.param_sharding(
                mesh, jax.eval_shape(build)))()

        params.update(self.init_tower())
        if mesh is not None:
            params = pmesh.shard_params(params, pmesh.param_sharding(mesh, params))
        return params

    def _init_tables(self, row_multiple: int) -> dict:
        """The hashed tables and their optimizer state, built on device with
        their row counts rounded up to ``row_multiple``."""
        mi = self.mi
        lr_rows = tables.round_up(self.lr_spec.num_rows, row_multiple)
        # jnp.full broadcasts on device; jnp.zeros would materialize on the
        # host and transfer the whole table
        params: dict = {
            "lr_w": jnp.full((lr_rows, tables.LANE), 0.0, jnp.float32)
        }
        if self.opt_lr.has_state:
            params["lr_acc"] = jnp.full(
                (lr_rows, tables.LANE), self.opt_lr.initial_acc(), jnp.float32)

        if self.has_ffm:
            # merand48-based init evaluated ON DEVICE (ops/init.py) — host
            # generation + transfer of multi-GB tables dominated startup;
            # floats past the table's size (its padding) are zero
            from ..ops import init as ffm_init

            n = self.ffm_size
            rows = tables.round_up(self.ffm_spec.num_rows, row_multiple)
            padded = rows * tables.LANE
            if mi.ffm_initialization_type != "default":
                raise ValueError("Please select a valid activation function.")
            if mi.ffm_init_width == 0.0:
                # (merand48(len+i) − 0.5) / √k / 50
                # (reference: src/block_ffm.rs:796-806)
                w = ffm_init.ffm_init_default(n, self.ffm_k, padded)
            else:
                # center/width/zero-band scheme (reference: src/block_ffm.rs:807-822)
                w = ffm_init.ffm_init_band(
                    n, padded, mi.ffm_init_width,
                    mi.ffm_init_zero_band, mi.ffm_init_center,
                )
            params["ffm_w"] = w.reshape(rows, tables.LANE)
            if self.opt_ffm.has_state:
                params["ffm_acc"] = jnp.full(
                    (rows, tables.LANE), self.opt_ffm.initial_acc(), jnp.float32)
        return params

    def init_tower(self) -> dict:
        """The tower's layers and readout (empty without a tower)."""
        if not self.has_nn:
            return {}
        # reference-exact init: each layer seeds a Xoshiro256++ from its
        # (emulated) tape offsets and draws Xavier-uniform / Hu-normal
        # weights through rand's exact float pipeline — bit-compatible
        # with the reference (reference: src/block_neural.rs:382-418;
        # offsets via models/ref_offsets.py)
        from . import ref_offsets

        offs = ref_offsets.reference_nn_offsets(
            self.num_combos,
            self.num_fields if self.has_ffm else 0,
            self.topology,
            [(s.width, s.layernorm, s.activation) for s in self.nn_layers],
        )
        layers = []
        d = self.joined_width
        for spec, off in zip(self.nn_layers, offs[:-1]):
            layers.append(self._init_layer(off, d, spec.width, spec.init))
            d = spec.width
        final_in = d + (self.joined_width if self.topology != "two" else 0)
        return {"nn": layers,
                "final": self._init_layer(offs[-1], final_in, 1, "one")}

    def _init_layer(self, off, fan_in: int, fan_out: int, init: str) -> dict:
        from ..ops import xoshiro
        from . import ref_offsets

        in_off, out_off, num_inputs, num_neurons = off
        assert num_inputs == fan_in and num_neurons == fan_out, (
            "ref_offsets layer shape drifted from the model builder",
            off, fan_in, fan_out,
        )
        if init in ("xavier", "hu"):
            rng = xoshiro.Xoshiro256PlusPlus(
                ref_offsets.layer_seed(in_off, out_off, fan_in, fan_out))
            n = fan_in * fan_out
            if init == "xavier":
                # uniform ±√6/√(num_inputs·num_neurons)
                # (reference: src/block_neural.rs:392-400)
                bound = float(np.sqrt(6.0)) / float(np.sqrt(n))
                seq = [rng.uniform(-bound, bound) for _ in range(n)]
            else:
                # Hu (He): Normal(0, √(2/num_inputs)) via rand_distr's
                # ziggurat (reference: src/block_neural.rs:401-407)
                std = float(np.sqrt(2.0 / fan_in))
                seq = [xoshiro.normal(rng, 0.0, std) for _ in range(n)]
            # the reference stores weights[neuron j][input i] contiguously
            # (sgemv col-major, lda=num_inputs): sequence is neuron-major
            w = np.array(seq, np.float32).reshape(fan_out, fan_in).T
        elif init == "one":
            w = np.ones((fan_in, fan_out))
        else:  # zero
            w = np.zeros((fan_in, fan_out))
        layer = {
            "w": jnp.asarray(w, jnp.float32),
            "b": jnp.zeros(fan_out, jnp.float32),  # bias always zero-init
        }
        if self.opt_nn.has_state:
            layer["w_acc"] = jnp.full((fan_in, fan_out), self.opt_nn.initial_acc(), jnp.float32)
            layer["b_acc"] = jnp.full(fan_out, self.opt_nn.initial_acc(), jnp.float32)
        return layer

    # -- forward pieces --------------------------------------------------------

    def lr_ids_combos(self, batch):
        """(ids, combos) for the LR features.

        The host may pack ``combo+1`` into the id bits above
        ``bit_precision`` and elide the combos array entirely (padding packs
        as 0 → combo −1, whose one-hot is the zero row)."""
        ids = batch["lr_ids"]
        if "lr_combos" in batch:
            return ids, batch["lr_combos"]
        shift = jnp.int32(self.mi.bit_precision)
        combos = jax.lax.shift_right_logical(ids, shift) - 1
        return ids & jnp.int32(self.mi.lr_hash_mask), combos

    def lr_outputs(self, lr_wg, batch) -> jnp.ndarray:
        """[B, C]: per-combo sums of w[hash]·value (reference: src/block_lr.rs:28-47).
        ``lr_wg`` is the gathered weight matrix [B, L].

        ``lr_vals`` may be absent: the host elides all-ones value arrays to
        cut transfer bytes; padding inertness then comes from combo −1
        (one_hot(−1) is the zero row)."""
        vals = batch.get("lr_vals")
        contrib = lr_wg if vals is None else lr_wg * vals  # [B, L]
        _, combos = self.lr_ids_combos(batch)
        onehot = jax.nn.one_hot(combos, self.num_combos, dtype=contrib.dtype)
        return jnp.einsum("bl,blc->bc", contrib, onehot, precision=self.precision)

    def gather_lr(self, params, batch):
        """Scalar weights w[h] for the LR ids → ([B, L], aux for backward)."""
        ids, _ = self.lr_ids_combos(batch)
        return tables.gather_scalars(params["lr_w"], ids)

    def gather_ffm(self, params, batch):
        """[B, N, F·k] embedding slabs → (slabs, aux for backward).

        Feature hash h owns the aligned flat window starting at
        ``h & ~(align−1)`` (see ops/tables.py — an aligned re-design of the
        reference's overlapping windows, src/block_ffm.rs:92-95)."""
        return tables.gather(params["ffm_w"], batch["ffm_ids"], self.ffm_spec)

    def ffm_outputs(self, emb, batch) -> jnp.ndarray:
        """[B, F, F] interaction matrix (reference math, see module docstring).

        ``emb`` is the gathered slab tensor [B, N, F·k]."""
        B, N, _ = emb.shape
        F, k = self.num_fields, self.ffm_k
        e = emb.reshape(B, N, F, k)  # e[b,n,t,:] = w_n→t
        vals = batch.get("ffm_vals")  # [B, N] or elided when all-ones
        onehot = jax.nn.one_hot(batch["ffm_fields"], F, dtype=e.dtype)  # [B,N,F]
        weighted = e if vals is None else e * vals[:, :, None, None]  # v_a·w_a→t
        # C[b,t,f,k] = Σ_{a∈f} v_a·w_a→t
        C = jnp.einsum("bnf,bntk->btfk", onehot, weighted, precision=self.precision)
        inter = 0.5 * jnp.einsum("btfk,bftk->btf", C, C, precision=self.precision)
        # subtract self-interactions on the diagonal:
        # 0.5·Σ_{a∈t} v_a²·‖w_a→t‖² (reference: src/block_ffm.rs:236-244)
        own = jnp.einsum("bntk,bnt->bnk", e, onehot, precision=self.precision)  # w_a→field(a)
        self_term = 0.5 * jnp.sum(own * own, axis=-1)  # [B,N]
        if vals is not None:
            self_term = self_term * vals * vals
        diag_corr = jnp.einsum("bn,bnf->bf", self_term, onehot, precision=self.precision)  # [B,F]
        return inter - diag_corr[:, :, None] * jnp.eye(F, dtype=inter.dtype)[None]

    def triangle(self, inter: jnp.ndarray) -> jnp.ndarray:
        """[B, F(F+1)/2] row-major lower triangle, off-diag ×2
        (reference: src/block_misc.rs:861-880)."""
        return inter[:, self._tri_i, self._tri_j] * jnp.asarray(self._tri_scale)

    def tower(self, params, x: jnp.ndarray, train: bool) -> jnp.ndarray:
        """Dense tower + final readout → [B] logits."""
        topo = self.topology
        if topo == "one":
            t, joined = x, x
        elif topo == "two":
            t, joined = x, None
        elif topo == "four":
            t = normalize_train(x) if train else normalize_predict(x)
            joined = x
        elif topo == "five":
            t, joined = jax.lax.stop_gradient(x), x
        else:
            raise ValueError(f'unknown nn topology: "{topo}"')

        for spec, layer in zip(self.nn_layers, params["nn"]):
            t = jnp.dot(t, layer["w"], precision=self.precision) + layer["b"]
            if spec.layernorm == "before":
                t = normalize_train(t) if train else normalize_predict(t)
            if spec.activation == "relu":
                t = jnp.where(t > 0.0, t, 0.0)
            if spec.layernorm == "after":
                t = normalize_train(t) if train else normalize_predict(t)
        if joined is not None:
            t = jnp.concatenate([t, joined], axis=-1)
        final = params["final"]
        return (jnp.dot(t, final["w"], precision=self.precision) + final["b"])[:, 0]

    # -- full forward -----------------------------------------------------------

    def forward_parts(self, params, lr_wg, emb, batch, train: bool) -> jnp.ndarray:
        """logits [B] from gathered sparse weights + dense params."""
        lr_out = self.lr_outputs(lr_wg, batch)  # [B, C]
        parts = [lr_out]
        if self.has_ffm:
            parts.append(self.triangle(self.ffm_outputs(emb, batch)))
        x = jnp.concatenate(parts, axis=-1) if len(parts) > 1 else parts[0]
        if self.has_nn:
            return self.tower(params, x, train)
        return jnp.sum(x, axis=-1)

    def predict(self, params, batch) -> jnp.ndarray:
        lr_wg, _ = self.gather_lr(params, batch)
        emb = self.gather_ffm(params, batch)[0] if self.has_ffm else None
        logits = self.forward_parts(params, lr_wg, emb, batch, train=False)
        return predict_prob(logits)
