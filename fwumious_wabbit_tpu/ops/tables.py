"""Row-structured hashed weight tables — the layout of the reference's
flat f32 weight arenas (reference: src/block_lr.rs:57-67,
src/block_ffm.rs:40-95) used by every device step.

Every table is stored as ``[num_rows, 128]`` f32 and all sparse traffic —
forward gathers, AdaGrad read-modify-write updates — moves whole 512-byte
rows: one row gather per lookup and one row scatter per update, with the
sub-row selection done as a one-hot contraction at HIGHEST precision (an
exact select: one product of 1.0 and the weight per output, the rest exact
zeros). Whether a flat table with scalar gathers serves the GPU better is
an open measurement (ROADMAP, Design 4).

Addressing:

* **LR** (slab = 1 float): hash h owns row ``h >> 7``, lane ``h & 127`` —
  exactly the reference's flat indexing, reshaped.
* **FFM** (slab = F·k floats): the reference lets slab windows of different
  hashes overlap arbitrarily (src/block_ffm.rs:92-95 guard band). We instead
  align slabs: hash h owns the flat window
  ``[h & ~(align−1), …) + F·k`` where ``align`` is F·k rounded up to a power
  of two (≤128) or to a multiple of 128 (>128). Aligned slabs never straddle
  a row except in whole-row multiples, so a lookup is 1 (or align/128)
  row-gathers. The table's byte size is unchanged (2^ffm_bit_precision
  floats, no guard band needed); the effective bucket count is
  2^fb / align instead of the reference's 2^fb / 2^ceil(log2 k) — an
  addressing re-design, not a translation (hash semantics stay identical
  upstream of the mask).

The per-row AdaGrad update preserves the reference's per-example semantics:
all of an example's contributions to a weight are summed FIRST and the
weight is updated once (reference: src/block_ffm.rs:265-288, SPEED.md), so
the accumulator receives ``(Σg)²`` per (example, weight) — not ``Σg²``.
:func:`dedup_rows` performs that per-example segment-sum before the scatter;
across examples the batch generalization is ``acc += Σ_e (Σ_within_e g)²``,
exact at batch size 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

LANE = 128
LANE_BITS = 7

# one-hot selections and the dedup sums are exact only at full f32
# precision: a float32 contraction that names no precision may run in TF32
# on the GPU, which keeps ~10 mantissa bits of every weight it selects
EXACT = jax.lax.Precision.HIGHEST


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class TableSpec:
    """Static geometry of one row table."""

    logical_size: int  # addressable flat floats (2^bits)
    slab: int  # floats returned per lookup
    align: int  # slab address granularity (pow2 or multiple of 128)
    rows_per_slab: int  # consecutive rows gathered per lookup
    padded_size: int  # physical flat floats (row multiple)

    @property
    def num_rows(self) -> int:
        return self.padded_size // LANE

    @property
    def positions(self) -> int:
        """Slab positions per row (align < 128 case)."""
        return LANE // self.align if self.align <= LANE else 1


def make_spec(logical_size: int, slab: int) -> TableSpec:
    if slab <= LANE:
        align = _next_pow2(slab)
        rows_per_slab = 1
    else:
        align = round_up(slab, LANE)
        rows_per_slab = align // LANE
    padded = round_up(max(logical_size, align), LANE * rows_per_slab)
    return TableSpec(logical_size, slab, align, rows_per_slab, padded)


# ---------------------------------------------------------------------------
# gather: ids → slabs
# ---------------------------------------------------------------------------


def gather(table: jnp.ndarray, ids: jnp.ndarray, spec: TableSpec):
    """Gather slabs for ``ids`` (any leading shape).

    Returns ``(slabs [..., slab], aux)`` — ``aux`` is reused by
    :func:`expand_grads` to place cotangents back into row layout.
    """
    if spec.rows_per_slab == 1:
        rid = jax.lax.shift_right_logical(ids, LANE_BITS)
        rows = jnp.take(table, rid, axis=0)  # [..., 128]
        P = spec.positions
        if P == 1:
            slabs = rows[..., : spec.slab]
            return slabs, (rid, None)
        pos_bits = (spec.align - 1).bit_length()  # log2(align)
        pos = jax.lax.shift_right_logical(ids & (LANE - 1), pos_bits)
        oh = jax.nn.one_hot(pos, P, dtype=table.dtype)  # [..., P]
        seg = rows.reshape(*rows.shape[:-1], P, spec.align)
        slabs = jnp.einsum("...p,...pa->...a", oh, seg,
                           precision=EXACT)[..., : spec.slab]
        return slabs, (rid, oh)
    # multi-row slabs (F·k > 128): consecutive whole rows
    G = spec.rows_per_slab
    rid0 = jax.lax.shift_right_logical(ids, LANE_BITS)
    rid = rid0[..., None] + jnp.arange(G, dtype=ids.dtype)  # [..., G]
    rows = jnp.take(table, rid, axis=0)  # [..., G, 128]
    slabs = rows.reshape(*rows.shape[:-2], G * LANE)[..., : spec.slab]
    return slabs, (rid, None)


def expand_grads(aux, g: jnp.ndarray, spec: TableSpec):
    """Per-occurrence slab cotangents ``g [..., slab]`` → row layout.

    Returns ``(rid_flat [K], grows [K, 128])`` ready for :func:`row_update`.
    """
    rid, oh = aux
    pad = (spec.align if spec.rows_per_slab == 1 else spec.rows_per_slab * LANE) - spec.slab
    if pad:
        g = jnp.concatenate([g, jnp.zeros((*g.shape[:-1], pad), g.dtype)], axis=-1)
    if spec.rows_per_slab == 1:
        if oh is None:
            grows = g
        else:
            P = spec.positions
            grows = jnp.einsum("...p,...a->...pa", oh, g,
                               precision=EXACT).reshape(*g.shape[:-1], LANE)
        return rid.reshape(-1), grows.reshape(-1, LANE)
    G = spec.rows_per_slab
    grows = g.reshape(*g.shape[:-1], G, LANE)
    return rid.reshape(-1), grows.reshape(-1, LANE)


# ---------------------------------------------------------------------------
# scalar tables (LR): lane-level gather/expand
# ---------------------------------------------------------------------------


def gather_scalars(table: jnp.ndarray, ids: jnp.ndarray):
    """Gather scalar weights w[h] for ``ids`` (any leading shape).

    Returns ``(vals [...], aux)``; the lane selection is a one-hot
    contraction over the gathered rows.
    """
    rid = jax.lax.shift_right_logical(ids, LANE_BITS)
    lane = ids & (LANE - 1)
    rows = jnp.take(table, rid, axis=0)  # [..., 128]
    oh = jax.nn.one_hot(lane, LANE, dtype=table.dtype)
    vals = jnp.einsum("...l,...l->...", rows, oh, precision=EXACT)
    return vals, (rid, oh)


def expand_scalar_grads(aux, g: jnp.ndarray):
    """Scalar cotangents ``g [...]`` → ``(rid_flat [K], grows [K, 128])``."""
    rid, oh = aux
    grows = oh * g[..., None]
    return rid.reshape(-1), grows.reshape(-1, LANE)


# ---------------------------------------------------------------------------
# per-example duplicate-id deduplication
# ---------------------------------------------------------------------------


def dedup_rows(rid: jnp.ndarray, grows: jnp.ndarray, batch: int,
               keys: jnp.ndarray | None = None):
    """Segment-sum each example's gradient rows with equal row id.

    The reference sums all of one example's contributions to a weight and
    updates it ONCE, so the AdaGrad accumulator receives ``(Σg)²`` — not the
    per-occurrence ``Σg²`` (reference: src/block_ffm.rs:265-288, SPEED.md;
    duplicates arise from the same feature repeated in a namespace or LR
    combo hash collisions). Each example's occurrences with equal row id are
    run-summed onto the first occurrence, the rest zeroed; the subsequent
    scatter in ``apply_rows`` then performs exactly one ``(Σg)²`` bump and
    one rated update per (example, row). Lanes never mix within a row, so
    per-*weight* semantics hold for both the LR one-hot-lane layout and FFM
    slabs.

    ``rid [K]`` int32, ``grows [K, 128]`` with ``K = batch·W``; returns
    same-shape ``(rid, grows)``. Two paths (see :func:`_dedup_runs`): a
    pairwise equality + one-hot contraction for moderate widths (order-
    preserving, no sort) and a sort-and-run-sum fallback for wide inputs.

    ``keys``: optional ``[batch, W]`` finer-grained merge keys (feature id
    for LR, window id for FFM). When host-side multiplicity counts ride the
    batch (``--fwt_batch_mean``), entries must only merge when their *count
    key* matches — merging two same-row entries with different keys would
    scale the merged row by the first entry's count only. Same-row
    different-key entries occupy disjoint lanes, so leaving them unmerged
    changes nothing for the scatter or the accumulator.
    """
    K = rid.shape[0]
    W = K // batch
    if W <= 1:
        return rid, grows
    if dedup_preserves_order(batch, W):
        k2 = rid.reshape(batch, W) if keys is None else keys
        _, g_d = _dedup_pairwise(k2, grows.reshape(batch, W, LANE))
        return rid, g_d.reshape(-1, LANE)
    r_s, g_d = _dedup_sort(rid.reshape(batch, W),
                           grows.reshape(batch, W, LANE))
    return r_s.reshape(-1), g_d.reshape(-1, LANE)


# the pairwise path's [B, W, W] f32 equality tensor must stay bounded: at
# B=32768 it is 2 GB for W=128. Above the budget the sort path takes over.
_PAIRWISE_EQ_BUDGET_BYTES = 128 << 20


def dedup_preserves_order(batch: int, W: int) -> bool:
    """True when dedup keeps entry order (the pairwise path) — the
    precondition for host-precomputed per-entry multiplicity counts riding
    the batch (train/step.py); the sort fallback reorders entries."""
    return W <= 128 and batch * W * W * 4 <= _PAIRWISE_EQ_BUDGET_BYTES


def _dedup_runs(keys: jnp.ndarray, payload: jnp.ndarray):
    """Per-example key-equality-class sum: each class's total lands on its
    first occurrence, the rest are zeroed.

    ``keys [B, W]`` int32, ``payload [B, W, P]``; returns same-shape
    ``(keys, payload_dedup)``.

    Two paths. For moderate widths, a pairwise comparison + one-hot
    contraction — B·W²·P flops, order-preserving, no sort — but its
    [B, W, W] equality tensor is gated by ``_PAIRWISE_EQ_BUDGET_BYTES`` (it
    would be ~2 GB at B=32k, W=128). Wide inputs take the sort-and-run-sum
    path, which reorders entries.
    """
    B, W = keys.shape
    if dedup_preserves_order(B, W):
        return _dedup_pairwise(keys, payload)
    return _dedup_sort(keys, payload)


def _dedup_pairwise(keys: jnp.ndarray, payload: jnp.ndarray):
    eq = keys[:, :, None] == keys[:, None, :]  # [B, W, W]
    dup_before = jnp.tril(eq, k=-1).any(axis=2)
    totals = jnp.einsum(
        "bij,bjp->bip", eq.astype(payload.dtype), payload, precision=EXACT
    )
    p_d = jnp.where(~dup_before[:, :, None], totals,
                    jnp.zeros((), payload.dtype))
    return keys, p_d


def _dedup_sort(keys: jnp.ndarray, payload: jnp.ndarray):
    B, W = keys.shape
    order = jnp.argsort(keys, axis=1)
    k_s = jnp.take_along_axis(keys, order, axis=1)
    p_s = jnp.take_along_axis(payload, order[:, :, None], axis=1)
    is_first = jnp.concatenate(
        [jnp.ones((B, 1), bool), k_s[:, 1:] != k_s[:, :-1]], axis=1
    )
    is_last = jnp.concatenate(
        [k_s[:, 1:] != k_s[:, :-1], jnp.ones((B, 1), bool)], axis=1
    )
    csum = jnp.cumsum(p_s, axis=1)
    idx = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (B, W))
    run_first = jax.lax.cummax(jnp.where(is_first, idx, 0), axis=1)
    run_last = -jax.lax.cummax(
        jnp.where(is_last, -idx, -(W - 1)), axis=1, reverse=True
    )
    totals = jnp.take_along_axis(csum, run_last[:, :, None], axis=1)
    base = jnp.take_along_axis(
        csum, jnp.maximum(run_first - 1, 0)[:, :, None], axis=1
    )
    totals = totals - jnp.where((run_first > 0)[:, :, None], base,
                                jnp.zeros((), payload.dtype))
    p_d = jnp.where(is_first[:, :, None], totals, jnp.zeros((), payload.dtype))
    return k_s, p_d


def expand_scalar_grads_dedup(ids: jnp.ndarray, g: jnp.ndarray):
    """LR cotangents with per-example dedup BEFORE lane expansion.

    ``ids [B, W]`` feature ids, ``g [B, W]`` scalar cotangents. An id maps
    bijectively to a (row, lane), so run-summing the *scalars* keyed by id
    is exactly the (Σg)² dedup — at 1/128th the memory traffic of deduping
    the expanded ``[K, 128]`` rows. Entries left separate that share a row
    but not a lane are harmless: the scatter-add updates lanes elementwise,
    and a zero lane contributes 0 to acc and weight.
    The lane one-hot is recomputed from the sorted ids.
    """
    if ids.shape[-1] > 1:
        ids, g = _dedup_runs(ids, g[..., None])
        g = g[..., 0]
    rid = jax.lax.shift_right_logical(ids, LANE_BITS)
    oh = jax.nn.one_hot(ids & (LANE - 1), LANE, dtype=g.dtype)
    grows = oh * g[..., None]
    return rid.reshape(-1), grows.reshape(-1, LANE)


def expand_grads_dedup(ids: jnp.ndarray, g: jnp.ndarray, spec: TableSpec):
    """FFM slab cotangents with per-example dedup before row expansion.

    Keyed by the window id ``ids >> log2(align)``: equal windows fully
    overlap (merge their slab vectors); distinct windows in one row occupy
    disjoint lanes and need no merging (elementwise updates — see
    :func:`expand_scalar_grads_dedup`). Falls back to expand + row-level
    dedup for multi-row slabs (F·k > 128).
    """
    if spec.rows_per_slab != 1:
        raise AssertionError("caller must use expand_grads + dedup_rows")
    pad = spec.align - spec.slab
    if pad:
        g = jnp.concatenate([g, jnp.zeros((*g.shape[:-1], pad), g.dtype)], axis=-1)
    pos_bits = (spec.align - 1).bit_length()  # log2(align)
    wid = jax.lax.shift_right_logical(ids, pos_bits)
    if ids.shape[-1] > 1:
        wid, g = _dedup_runs(wid, g)
    rid = jax.lax.shift_right_logical(wid, LANE_BITS - pos_bits)
    P = spec.positions
    if P == 1:
        grows = g
    else:
        oh = jax.nn.one_hot(wid & (P - 1), P, dtype=g.dtype)
        grows = jnp.einsum("...p,...a->...pa", oh, g,
                           precision=EXACT).reshape(*g.shape[:-1], LANE)
    return rid.reshape(-1), grows.reshape(-1, LANE)
