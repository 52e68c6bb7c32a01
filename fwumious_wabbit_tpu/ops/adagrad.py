"""Optimizers: SGD, AdaGrad-with-flexible-power_t, and the AdaGrad
lookup-table fast path.

Update rules are bit-faithful to the reference (reference: src/optimizer.rs):

* SGD: ``update = g * lr`` (src/optimizer.rs:34-37)
* AdagradFlex: ``acc += g²; update = g * lr * acc^(-power_t)``; NaN/Inf
  updates are zeroed (src/optimizer.rs:76-89)
* AdagradLUT: a 2^11-entry table indexed by the top 11 bits of acc's f32 bit
  pattern; each entry averages ``lr * x^(-power_t)`` at the bucket edges with
  ``initial_acc_gradient`` folded in (src/optimizer.rs:96-162). The hot
  path recomputes the bucket value arithmetically instead of gathering it.

**Batch semantics.** The reference is an online learner: one update per
weight per example, gradient summed over the example's contributions first
(reference: src/block_ffm.rs:265-288, SPEED.md). The batched step
preserves this per-example shape — ``tables.dedup_rows`` segment-sums each
example's contributions per weight before the update, so per weight:

    g_e   = Σ (contributions of example e)     (dedup_rows)
    acc  += Σ_examples g_e²                     (one (Σg)² bump per example)
    w    -= (Σ_examples g_e) · rate(acc_new)

At batch size 1 this is exactly the reference's update (one example, one
acc bump, one weight step) — including duplicated ids within the example.
For B>1 the trajectory differs from sequential online AdaGrad (as any
synchronous batching must); parity is validated statistically on the
benchmark datasets.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

FASTMATH_LR_LUT_BITS = 11
FASTMATH_LR_LUT_SIZE = 1 << FASTMATH_LR_LUT_BITS

# Smallest normal f32. Denormal bucket edges are flushed to zero in BOTH the
# table (build_lut) and the arithmetic hot path (lut_rate_compute) so the two
# are bit-identical: XLA's pow may flush denormal inputs (flush-to-zero
# arithmetic) while numpy's does not. Under flush-to-zero a denormal
# accumulator is unreachable (the g² accumulation itself flushes), so this
# deviates from the reference table
# only in buckets that cannot be hit; flushed buckets fall back to plain
# ``learning_rate``, same as the acc==0 bucket (reference: src/optimizer.rs:
# 121-144 builds huge-but-finite entries there instead).
_FLT_MIN = np.float32(2.0 ** -126)

# optimizer kinds (values match the reference's enum for file compat)
OPT_SGD = 100
OPT_ADAGRAD_FLEX = 200
OPT_ADAGRAD_LUT = 300


def build_lut(learning_rate: float, power_t: float, initial_acc_gradient: float) -> np.ndarray:
    """Precompute the 2048-entry learning-rate table
    (reference: src/optimizer.rs:121-144)."""
    lut = np.zeros(FASTMATH_LR_LUT_SIZE, dtype=np.float32)
    minus_power_t = -power_t
    def edge(x):
        v = np.uint32(x << (31 - FASTMATH_LR_LUT_BITS)).view(np.float32)
        if abs(v) < _FLT_MIN:  # flush denormal edges (see _FLT_MIN note)
            v = np.float32(0.0)
        return v + np.float32(initial_acc_gradient)

    with np.errstate(all="ignore"):
        for x in range(FASTMATH_LR_LUT_SIZE):
            fx = edge(x)
            fx1 = edge(x + 1)
            val = (
                np.float32(learning_rate)
                * (np.float32(fx) ** np.float32(minus_power_t)
                   + np.float32(fx1) ** np.float32(minus_power_t))
                * np.float32(0.5)
            )
            if not np.isfinite(val):
                val = np.float32(learning_rate)
            lut[x] = val
    return lut


def lut_rate(acc: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """rate = lut[bits(acc) >> 20] (reference: src/optimizer.rs:146-156).

    Table-lookup form — used in scalar/unit-test contexts. The hot path uses
    :func:`lut_rate_compute`, which evaluates the same bucket function
    arithmetically (recomputing is elementwise work that fuses into the
    update; a per-element table gather does not)."""
    key = jax.lax.shift_right_logical(
        jax.lax.bitcast_convert_type(acc, jnp.uint32),
        jnp.uint32(31 - FASTMATH_LR_LUT_BITS),
    )
    return jnp.take(lut, key.astype(jnp.int32), axis=0)


def lut_rate_compute(acc: jnp.ndarray, learning_rate: float, power_t: float,
                     initial_acc_gradient: float) -> jnp.ndarray:
    """The LUT entry for ``acc``, recomputed instead of looked up.

    Bit-identical semantics to :func:`build_lut` + :func:`lut_rate`: quantize
    ``acc`` to its 11-bit bucket (sign+exponent+mantissa MSBs of the f32 bit
    pattern), evaluate ``lr·x^(−power_t)`` at both bucket edges with
    ``initial_acc_gradient`` folded in, average, and clamp non-finite entries
    to ``lr`` (reference: src/optimizer.rs:121-156): bitcasts, shifts and
    two pows — no memory-bound table gather.
    """
    shift = jnp.uint32(31 - FASTMATH_LR_LUT_BITS)
    key = jax.lax.shift_right_logical(
        jax.lax.bitcast_convert_type(acc, jnp.uint32), shift
    )

    def edge(k):
        v = jax.lax.bitcast_convert_type(jax.lax.shift_left(k, shift), jnp.float32)
        # flush denormal edges so this matches build_lut bit-for-bit
        # (tested over all 2048 buckets in test_model_parity.py)
        v = jnp.where(jnp.abs(v) < _FLT_MIN, jnp.float32(0.0), v)
        return v + jnp.float32(initial_acc_gradient)

    e0 = edge(key)
    e1 = edge(key + jnp.uint32(1))
    mpt = jnp.float32(-power_t)
    val = jnp.float32(learning_rate) * jnp.float32(0.5) * (
        jnp.power(e0, mpt) + jnp.power(e1, mpt)
    )
    return jnp.where(jnp.isfinite(val), val, jnp.float32(learning_rate))


def flex_update(gsum, acc_new, learning_rate, power_t):
    """AdagradFlex update given the already-bumped accumulator; NaN/Inf → 0
    (reference: src/optimizer.rs:76-89)."""
    upd = gsum * learning_rate * jnp.power(acc_new, -power_t)
    return jnp.nan_to_num(upd, nan=0.0, posinf=0.0, neginf=0.0)


class ScopedOptimizer:
    """One optimizer instance per scope (lr / ffm / nn), mirroring the
    reference's per-block monomorphization (reference: src/block_ffm.rs:50-60).
    """

    def __init__(self, kind: int, learning_rate: float, power_t: float,
                 initial_acc_gradient: float, batch_mean: bool = False,
                 batch_cap: float = 8.0):
        self.kind = kind
        self.learning_rate = float(learning_rate)
        self.power_t = float(power_t)
        self.initial_acc_gradient = float(initial_acc_gradient)
        # batch_mean: cap each weight's effective per-batch multiplicity at
        # batch_cap — see batch_mean_grads. Identical at batch size 1;
        # cap=1.0 is a pure per-weight mean.
        self.batch_mean = bool(batch_mean)
        self.batch_cap = float(batch_cap)
        self.lut = (
            build_lut(learning_rate, power_t, initial_acc_gradient)
            if kind == OPT_ADAGRAD_LUT
            else None
        )

    @property
    def has_state(self) -> bool:
        return self.kind != OPT_SGD

    def initial_acc(self) -> float:
        """Initial per-weight accumulator. For LUT the initial gradient is
        folded into the table instead (reference: src/optimizer.rs:158-161)."""
        if self.kind == OPT_ADAGRAD_FLEX:
            return self.initial_acc_gradient
        return 0.0

    def apply_dense(self, w, acc, gsum, gsq):
        """Dense update: w/acc/gsum/gsq all same shape. Returns (w, acc)."""
        if self.kind == OPT_SGD:
            return w - gsum * self.learning_rate, acc
        acc_new = acc + gsq
        if self.kind == OPT_ADAGRAD_LUT:
            upd = gsum * lut_rate_compute(
                acc_new, self.learning_rate, self.power_t, self.initial_acc_gradient
            )
        else:
            upd = flex_update(gsum, acc_new, self.learning_rate, self.power_t)
        return w - upd, acc_new

    def count_factor(self, counts):
        """Batch-mean cap factor per entry: ``min(1, cap/c)`` from host
        multiplicity counts (u8 soft-float codes or plain ints).

        Applied to the PRE-EXPANSION scalar/slab gradients in the train
        step (train/step.py): the factor is a function of the entry's id
        alone, so scaling every occurrence before the dedup run-sum is
        the same cap as scaling the summed rows after it — but touches
        [B, W] scalars instead of [B·W, 128] rows (measured ~25 ms of a
        269 ms LR superbatch on the expanded form), and drops the
        positional rid↔counts alignment constraint entirely (any dedup
        path works, including the reordering sort fallback)."""
        c = counts
        if c.dtype == jnp.uint8:
            c = decode_counts(c)
        c = jnp.maximum(c.astype(jnp.float32), 1.0)
        return jnp.minimum(jnp.float32(1.0), jnp.float32(self.batch_cap) / c)

    def apply_rows(self, w, acc, rid, grows, counts=None, pre_scaled=False):
        """Sparse update of a row table (see ops/tables.py) — only touched
        rows move through HBM, never the full table.

        ``rid [K]`` row ids, ``grows [K, 128]`` gradient rows. Sequence:
        scatter-add squared gradients into the accumulator, re-gather the
        *bumped* accumulator rows, rate them, scatter-subtract ``rate · g``.

        Duplicate ids within one example MUST be pre-summed by
        ``tables.dedup_rows`` (the train steps do this) so the accumulator
        receives ``(Σg)²`` per (example, weight) — the reference sums an
        example's contributions and updates each weight once (reference:
        src/optimizer.rs:76-89, src/block_ffm.rs:265-288, SPEED.md).
        Duplicates *across* examples still sum on the scatter and share the
        post-bump rate — the batch form of sequential per-example updates.
        """
        if self.batch_mean and not pre_scaled:
            if counts is not None:
                # host-precomputed multiplicities ([K], 0 on padding): the
                # ~14 ms C++ radix pass replaces a ~32 ms device sort AND
                # moves it off the device onto the pipelined producer
                # (measured step 72 → 31.5 ms at B=32k, power_t 0). Keyed
                # per weight (LR) / per window (FFM) — the same granularity
                # as the device path's per-lane run counts. uint8 arrays are
                # soft-float codes (see decode_counts).
                grows = grows * self.count_factor(counts)[:, None]
            else:
                grows = batch_mean_grads(w.shape[0], rid, grows, self.batch_cap)
        if self.kind == OPT_SGD:
            return w.at[rid].add(-self.learning_rate * grows), acc
        acc_new = acc.at[rid].add(grows * grows)
        acc_rows = jnp.take(acc_new, rid, axis=0)
        if self.kind == OPT_ADAGRAD_LUT:
            upd = grows * lut_rate_compute(
                acc_rows, self.learning_rate, self.power_t, self.initial_acc_gradient
            )
        else:
            upd = flex_update(grows, acc_rows, self.learning_rate, self.power_t)
        return w.at[rid].add(-upd), acc_new


def encode_counts(c: np.ndarray) -> np.ndarray:
    """NumPy mirror of the native engine's 8-bit count encoding
    (fw_native.cpp encode_count) for the Python-ingest path: 0–15 exact,
    ``e<<3 | (m−8)`` with c rounded UP above. Keeps both engines
    bit-identical on batch-mean configs."""
    c = np.asarray(c, np.int64)
    out = c.astype(np.uint8)
    big = c > 15
    if big.any():
        cb = c[big]
        e = np.floor(np.log2(cb)).astype(np.int64)
        m = -(-cb // (1 << np.maximum(e - 3, 0)))  # ceil divide
        bump = m == 16
        e[bump] += 1
        m[bump] = 8
        out[big] = ((e << 3) | (m - 8)).astype(np.uint8)
    return out


def decode_counts(code: jnp.ndarray) -> jnp.ndarray:
    """Decode the native engine's 8-bit soft-float multiplicity codes
    (fw_native.cpp encode_count): 0–15 exact; above that
    ``c = (8 + (code & 7)) << ((code >> 3) − 3)``, rounded up on encode so
    the batch-mean cap only ever gets ≤12.5% more conservative. Keeps the
    host→device counts array at 1 byte per entry."""
    code = code.astype(jnp.int32)
    e = jax.lax.shift_right_logical(code, 3)
    m = code & 7
    big = jax.lax.shift_left(8 + m, jnp.maximum(e - 3, 0))
    return jnp.where(code < 16, code, big).astype(jnp.float32)


def batch_mean_grads(num_rows: int, rid, grows, cap: float = 8.0):
    """Cap each weight's effective per-batch multiplicity at ``cap``:
    ``g_eff = Σ_e g_e · min(1, cap/c)`` per weight, where c is the number of
    examples contributing to that weight (lane-wise: lanes of a row are
    independent weights).

    Why: synchronous batching changes the stability region of the
    reference's online updates. With ``--power_t 0`` the AdaGrad rate is a
    constant ``lr`` (no accumulator self-stabilization), so a weight touched
    by c examples moves ``lr·Σ_e g_e`` per step — at c ≈ batch size (a
    constant feature, popular ids) this overshoots and diverges where the
    reference's per-example feedback loop converges (measured: the
    reference's own benchmark config at batch 16384 reaches logloss 13.9
    summed vs 0.745 capped vs 0.749 true online). A PURE per-weight mean
    (cap=1) is stable but slows low-multiplicity learning — it drops the
    FFM gate's balanced accuracy from 0.93 to 0.49, because FFM latent
    factors bootstrap multiplicatively and their ids have c ≈ 2–7. The cap
    keeps weights with c ≤ cap bit-identical to the summed form and bounds
    every weight's per-step movement by ``cap`` online updates' worth.

    Identical at batch size 1 in all modes (c == 1 ≤ cap), preserving
    --fwt_exact parity. Enabled by ``--fwt_batch_mean`` (auto: on when
    power_t == 0); cap from ``--fwt_batch_cap``.

    Must run AFTER tables.dedup_rows (counts are per example per weight; a
    weight contributed with an exact 0.0 gradient is not counted — such
    contributions are inert either way).

    Counts are computed by sorting the K occurrence rows and run-summing —
    NOT by scatter into a table-sized buffer (which would materialize a
    2 GB temporary per step on a 2^29 table). ``num_rows`` only bounds the
    id range.
    """
    del num_rows
    K = rid.shape[0]
    if K <= 1:
        return grows
    touched = (grows != 0.0).astype(grows.dtype)
    order = jnp.argsort(rid)
    rs = jnp.take(rid, order)
    ts = jnp.take(touched, order, axis=0)
    # per-lane run totals over runs of equal rid in sorted order:
    # csum[k] − csum[start_of_run − 1], broadcast to every member of the run
    csum = jnp.cumsum(ts, axis=0)
    is_first = jnp.concatenate(
        [jnp.ones((1,), bool), rs[1:] != rs[:-1]])
    idx = jnp.arange(K, dtype=jnp.int32)
    # last index of each run, propagated to all members (reverse cummin of
    # "next run's first − 1" == forward trick: run_last = (next first) − 1)
    first_idx = jnp.where(is_first, idx, 0)
    run_first = jax.lax.cummax(first_idx)  # start index of my run
    is_last = jnp.concatenate([rs[1:] != rs[:-1], jnp.ones((1,), bool)])
    last_idx = jnp.where(is_last, idx, K - 1)
    run_last = -jax.lax.cummax(-last_idx, reverse=True)
    base = jnp.take(csum, jnp.maximum(run_first - 1, 0), axis=0)
    base = jnp.where((run_first > 0)[:, None], base, jnp.float32(0.0))
    c_sorted = jnp.take(csum, run_last, axis=0) - base  # [K, 128] run totals
    c = jnp.maximum(c_sorted, 1.0)
    gs = jnp.take(grows, order, axis=0)
    scaled = gs * jnp.minimum(jnp.float32(1.0), jnp.float32(cap) / c)
    # undo the permutation
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(K, dtype=order.dtype))
    return jnp.take(scaled, inv, axis=0)
