"""Superbatch packing: K train batches → ONE contiguous u32 buffer → ONE
host→device transfer → ONE jitted lax.scan dispatch → ONE prediction fetch.

Why. Where every host↔device call pays a fixed latency, the loop's ceiling
is set by the number of calls, not by bytes: each distinct array is its own
transfer and each step its own dispatch. Packing K batches into a single
``[K, words]`` u32 buffer makes one transfer of K·leaves arrays, the scan
collapses K dispatches into one, and predictions come back ``[K, B]`` in
one fetch. Whether this pays on a local PCIe link to a GPU is for the
ledger to show (ROADMAP, Design 2). Training semantics are UNCHANGED: the
scan runs the same per-batch steps sequentially with the same batch size —
the trajectory is bit-identical to the unpacked loop (asserted in
tests/test_packed.py).

The reference has no analogue (its device is the CPU it runs on); this is
device plumbing for the reference's single-stream train loop
(reference: src/main.rs:213-270).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

# dtype → words-per-element numerator/denominator (all sizes divide 4)
_DTYPES = {
    np.dtype(np.int32): jnp.int32,
    np.dtype(np.uint32): jnp.uint32,
    np.dtype(np.float32): jnp.float32,
    np.dtype(np.uint8): jnp.uint8,
    np.dtype(np.int8): jnp.int8,
    np.dtype(np.uint16): jnp.uint16,
    np.dtype(np.int16): jnp.int16,
}


@dataclass(frozen=True)
class _Field:
    key: str
    dtype: str  # numpy dtype str
    shape: tuple
    word_off: int
    word_len: int


@dataclass(frozen=True)
class PackedLayout:
    """Static byte layout of one packed batch (a row of the superbatch).

    ``appends``: constant columns elided from the transfer, re-synthesized
    on device by :func:`unpack_row` — tuple of (key, scalar). The constant
    feature is the canonical case: on a fixed-width schema its id (and its
    multiplicity code) are identical in every example of a full batch, so
    shipping the column is 5 B/example of pure redundancy (~8% of the
    Eat-Rate payload on a link that is the measured bottleneck).

    ``bitpacks``: id columns shipped bit-packed — tuple of (key, bits, W):
    the batch dict carries ``[B, ceil(W·bits/32)]`` u32 words and
    :func:`unpack_row` restores ``[B, W]`` i32 with static shifts/masks
    (fused into the consuming step by XLA). Hash ids only occupy
    ``bit_precision`` (+ packed-combo) bits — 27 on the b=25 benchmark
    schema — so shipping i32 wastes ~16% of the dominant uplink column on
    a link that is the measured end-to-end bottleneck.

    ``row_broadcasts``: columns whose every example row is identical
    (fixed-width schemas: the FFM field indices and — when not packed into
    the ids — the combo indices are the same in each example), elided from
    the transfer and re-broadcast device-side — tuple of
    (key, dtype_str, row_values, B).

    ``vocabs``: id columns shipped as per-column dictionary indices —
    tuple of (key, widths, bases, n_rows): column j ships ``widths[j]``
    bits (mixed-width row-major bit-pack); on device, a column with
    ``bases[j] >= 0`` resolves ``id = vocab_flat[bases[j] + index]``
    against the device-resident [n_rows, 128] i32 vocabulary snapshot
    (row-gather + integer lane select, the tables' row layout),
    while ``bases[j] == -1`` columns carry raw ids (high-cardinality
    columns, e.g. LR interaction combos, degrade to direct). See
    :func:`encode_vocab_ids`.

    ``count_tabs``: multiplicity-count columns shipped as a u8 SHADOW of
    the vocab regions — tuple of (counts_key, ids_key): within a batch a
    given id has one global multiplicity, so for dictionary columns the
    per-entry code column is redundant with a per-(column, index) table
    (``counts_key + '_tab'``, one u8 per vocab slot ≈ 5 B/example vs 12
    on the Eat-Rate schema); direct columns keep per-entry codes in a
    narrowed ``counts_key`` array. See :func:`table_counts`.

    ``bit_cols``: binary per-example columns (the 0/1 label) shipped as
    ONE bit per example across the batch — tuple of (key, n): the batch
    dict carries ``[n/32]`` u32 words and :func:`unpack_row` restores
    ``[n]`` u8 with a broadcast shift/mask (1 vs 8 bits per example).
    See :func:`bitpack_labels`."""

    fields: tuple  # tuple[_Field]
    words: int
    appends: tuple = ()
    bitpacks: tuple = ()
    row_broadcasts: tuple = ()
    vocabs: tuple = ()
    count_tabs: tuple = ()
    bit_cols: tuple = ()

    @property
    def signature(self):
        return (tuple((f.key, f.dtype, f.shape) for f in self.fields),
                self.appends, self.bitpacks, self.row_broadcasts,
                self.vocabs, self.count_tabs, self.bit_cols)


def layout_of(bd: dict, appends: tuple = (), bitpacks: tuple = (),
              row_broadcasts: tuple = (), vocabs: tuple = (),
              count_tabs: tuple = (), bit_cols: tuple = ()) -> PackedLayout | None:
    """Build the layout for a batch dict, or None if it cannot pack
    (unknown dtype or a byte count not divisible by 4)."""
    fields = []
    off = 0
    for key in sorted(bd):
        a = bd[key]
        if not isinstance(a, np.ndarray) or a.dtype not in _DTYPES:
            return None
        nbytes = int(a.nbytes)
        if nbytes % 4:
            return None
        wl = nbytes // 4
        fields.append(_Field(key, a.dtype.str, tuple(a.shape), off, wl))
        off += wl
    return PackedLayout(tuple(fields), off, tuple(appends), tuple(bitpacks),
                        tuple(row_broadcasts), tuple(vocabs),
                        tuple(count_tabs), tuple(bit_cols))


CONSTANT_HASH = 11650396  # the VW constant feature (ingest/translator.py)


def strip_constant_columns(bd: dict, lr_hash_mask: int):
    """If the LAST lr column is the constant feature with a uniform packed
    id (and uniform count code), drop it from the transfer payload and
    return the append spec for :func:`unpack_row` to re-synthesize it.

    Fixed-width schemas (every example has the same feature count — e.g.
    the whole Eat-Rate benchmark family) qualify on every full batch; a
    variable-width schema fails the uniformity check and ships unchanged.
    Returns (bd, appends) — bd unchanged when not strippable."""
    ids = bd.get("lr_ids")
    if ids is None or ids.ndim != 2 or ids.shape[1] < 2:
        return bd, ()
    last = ids[:, -1]
    v = int(last[0])
    if (v & lr_hash_mask) != (CONSTANT_HASH & lr_hash_mask):
        return bd, ()
    if not (last == v).all():
        return bd, ()
    appends = [("lr_ids", v)]
    out = dict(bd)
    out["lr_ids"] = ids[:, :-1]
    counts = bd.get("lr_counts")
    if counts is not None:
        c = int(counts[0, -1])
        if not (counts[:, -1] == c).all():
            return bd, ()  # mixed multiplicities: ship unchanged
        # contiguous: pack()'s flat memcpy of a strided view costs ~6x
        # per byte (measured 0.22 ms vs 0.13 ms for 4x the bytes)
        out["lr_counts"] = np.ascontiguousarray(counts[:, :-1])
        appends.append(("lr_counts", c))
    return out, tuple(appends)


def bitpack_ids(bd: dict, key: str, bits: int):
    """Bit-pack the non-negative id column ``bd[key]`` ([B, W] i32) into
    ``[B, ceil(W·bits/32)]`` u32 words. Returns (bd, bitpacks) — unchanged
    when packing would not shrink the column, ``bits`` exceeds 31, or any
    id overflows ``bits`` (checked; overflow ships unpacked instead of
    corrupting). Padding entries are 0 and round-trip as 0."""
    a = bd.get(key)
    if a is None or a.ndim != 2 or a.dtype != np.int32 or bits > 31:
        return bd, ()
    W = a.shape[1]
    words = (W * bits + 31) // 32
    if words >= W or W == 0 or a.size == 0:
        return bd, ()
    from .. import native as fw_native

    out = fw_native.bitpack_ids(a, bits, words)  # C row-major bit-writer
    if out is False:  # a value overflows `bits`: ship the column unpacked
        return bd, ()
    if out is None:  # no native lib: numpy fallback (strided, ~5 ms/batch)
        if int(a.max()) >= (1 << bits) or int(a.min()) < 0:
            return bd, ()
        v = a.view(np.uint32)  # same buffer — values proven non-negative
        out = np.zeros((a.shape[0], words), np.uint32)
        for j in range(W):
            o = j * bits
            w0, s = o // 32, o % 32
            out[:, w0] |= v[:, j] << np.uint32(s)  # u32 shift truncates
            if s + bits > 32:
                out[:, w0 + 1] |= v[:, j] >> np.uint32(32 - s)
    nb = dict(bd)
    nb[key] = out
    return nb, ((key, bits, W),)


def bitpack_labels(bd: dict, key: str = "label"):
    """Ship a 0/1 u8 column as one bit per example (8× smaller): the label
    is 1 B/example of the Eat-Rate payload whose information content is one
    bit. Guards: u8 dtype, values ≤ 1 (the 255 NO_LABEL sentinel only occurs
    on predict paths, which never pack), and a 32-divisible batch so the
    words view is exact. Device inverse in :func:`unpack_row` is a single
    broadcast shift/mask (reference label layout: src/parser.rs packed
    records carry the label word; ours is already a u8 column)."""
    lab = bd.get(key)
    if (lab is None or not isinstance(lab, np.ndarray)
            or lab.dtype != np.uint8 or lab.ndim != 1
            or lab.size % 32 != 0 or (lab > 1).any()):
        return bd, ()
    words = np.packbits(lab, bitorder="little").view(np.uint32)
    out = dict(bd)
    out[key] = words
    return out, ((key, int(lab.size)),)


def strip_uniform_rows(bd: dict, key: str):
    """If every example row of ``bd[key]`` is identical (fixed-width
    schemas: FFM field indices, unpacked combo indices), drop the column
    from the transfer and return the row-broadcast spec for
    :func:`unpack_row` to re-synthesize it."""
    a = bd.get(key)
    if a is None or not isinstance(a, np.ndarray) or a.ndim != 2 \
            or a.shape[0] == 0 or a.shape[1] == 0:
        return bd, ()
    if not (a == a[0]).all():
        return bd, ()
    nb = dict(bd)
    del nb[key]
    return nb, ((key, a.dtype.str, tuple(int(x) for x in a[0]),
                 int(a.shape[0])),)


def unpack_uniform_combos(slim: dict, appends: tuple, mi):
    """When the host packed ``combo+1`` into the id bits above
    ``bit_precision`` (train/loop.py slim()) and every example's combo row
    is identical — true for any fixed-width schema — move the combos out of
    the ids into a zero-byte row-broadcast so the ids bit-pack at
    ``bit_precision`` instead of ``bit_precision + combo`` bits (13×25 vs
    13×29 bits on the b=25 Eat-Rate schema: 44 vs 48 B/example on the
    measured-bottleneck uplink). Only engages when it saves whole u32
    words. Returns (slim, appends, row_broadcasts)."""
    shift_bits = (mi.num_combos + 1).bit_length()
    if mi.bit_precision + shift_bits > 31 or "lr_combos" in slim:
        return slim, appends, ()  # ids are not combo-packed
    ids = slim.get("lr_ids")
    if ids is None or ids.ndim != 2 or ids.shape[1] == 0 \
            or ids.dtype != np.int32 or ids.shape[0] == 0:
        return slim, appends, ()
    W = ids.shape[1]
    packed_bits = mi.bit_precision + shift_bits
    if (W * mi.bit_precision + 31) // 32 >= (W * packed_bits + 31) // 32:
        return slim, appends, ()  # no whole-word saving at this width
    high = ids >> np.int32(mi.bit_precision)  # combo+1 (0 at padding)
    row0 = high[0]
    if not (high == row0).all():
        return slim, appends, ()  # variable combo layout: keep packed
    combo_row = row0.astype(np.int32) - 1  # padding → −1 (zero one-hot)
    new_appends = []
    for key, v in appends:
        if key == "lr_ids":
            # the elided constant column's combo joins the broadcast row;
            # its re-appended id sheds the combo bits like the rest
            combo_row = np.append(combo_row,
                                  np.int32((v >> mi.bit_precision) - 1))
            v = int(v & mi.lr_hash_mask)
        new_appends.append((key, v))
    out = dict(slim)
    out["lr_ids"] = ids & np.int32(mi.lr_hash_mask)
    rb = (("lr_combos", np.dtype(np.int32).str,
           tuple(int(x) for x in combo_row), int(ids.shape[0])),)
    return out, tuple(new_appends), rb


class VocabTransferState:
    """Owns the persistent native VocabEncoder across a training stream
    (one per producer). Recreates the encoder with fresh dictionaries if
    the schema's high-water column count outgrows it (index assignments
    restart; the next group ships a new signature + full snapshot)."""

    def __init__(self, max_cap: int = 1 << 14):
        # 2^14 keeps every realistic categorical-namespace dictionary
        # (measured Eat-Rate: 2k/10k uniques) while making unbounded
        # columns (the AB interaction: 32k+ uniques in the FIRST batch)
        # overflow to direct DURING batch 0 — one stable layout signature
        # for the whole run instead of a mid-run re-signature + recompile
        self.venc = None
        self.max_cap = max_cap
        self._grow_to = 0  # deferred-recreation width (see encoder_for)
        # latched once encoding can never pay off (dictionary widths only
        # grow, so a no-saving verdict is permanent) — stops the per-batch
        # native sweep on schemas where vocab encoding never engages
        self.disabled = False

    def encoder_for(self, n_cols: int):
        if self.venc is not None and self.venc.n_cols < n_cols:
            # DEFER recreation (r4 review): a pending packed group may
            # still need the OLD dictionaries for its snapshot export —
            # recreating here would flush that group against re-minted,
            # differently-ordered entries (silent wrong-id resolution).
            # Returning None ships THIS batch plain; its signature
            # mismatch flushes the pending group (old snapshot exported
            # by the producer, synchronously) and the next call recreates
            # safely.
            if self._grow_to:
                # the flush already happened while processing the plain
                # batch above; recreate now at the grown width
                self.venc.close()
                self.venc = None
            else:
                self._grow_to = n_cols
                return None
        if self.venc is None:
            from .. import native as fw_native

            self.venc = fw_native.VocabEncoder(
                max(n_cols, self._grow_to, 16), self.max_cap)
            self._grow_to = 0
        return self.venc

    def close(self):
        if self.venc is not None:
            self.venc.close()
            self.venc = None


def _vocab_width(size: int) -> int:
    """Wire bits for a dictionary of ``size`` entries — exact width
    rounded up to EVEN, so a growing dictionary only re-signatures (and
    recompiles the superbatch program) every 4× growth."""
    w = max(4, int(size - 1).bit_length() if size > 1 else 1)
    return w + (w & 1)


def encode_vocab_ids(slim: dict, appends: tuple, mi,
                     state: VocabTransferState):
    """Dictionary-encode ``slim['lr_ids']`` for the transfer.

    One fused native sweep (fwn_vocab_encode2) extracts/verifies the
    batch-uniform combo row from combo-packed ids, masks them, and maps
    each column to dense dictionary indices; each column then ships
    ``_vocab_width(dict_size)`` bits instead of ``bit_precision``
    (measured Eat-Rate schema: 2 columns at 12 bits + 10 at 14 + the
    unbounded AB interaction column direct at 25 → 38 vs 62 B/example on
    the measured-bottleneck uplink); the device resolves indices against
    the vocabulary snapshot (see :class:`PackedLayout` and
    :func:`export_vocab`). Only engages when it saves whole u32 words
    over the plain uniform bit-pack. Returns
    (slim, appends, row_broadcasts, vocabs_spec, idx_sizes) — idx_sizes
    is (idx, sizes): the raw [B, W] i32 index matrix (dictionary indices
    for vocab columns, masked ids for direct ones) and the exact
    per-column dictionary sizes (-1 direct), reused by
    :func:`table_counts`; all unchanged/empty (idx_sizes None) when the
    encoding does not apply (variable combo layout, no native lib, no
    saving)."""
    ids = slim.get("lr_ids")
    if state.disabled or ids is None or ids.ndim != 2 \
            or ids.shape[1] == 0 or ids.dtype != np.int32 \
            or ids.shape[0] == 0:
        return slim, appends, (), (), None
    shift_bits = (mi.num_combos + 1).bit_length()
    combos_packed = ("lr_combos" not in slim
                     and mi.bit_precision + shift_bits <= 31)
    W = ids.shape[1]
    venc = state.encoder_for(W)
    if venc is None:  # deferred encoder recreation: ship plain this batch
        return slim, appends, (), (), None
    res = venc.encode2(ids, mi.bit_precision if combos_packed else 0,
                       mi.lr_hash_mask)
    if res is None:
        return slim, appends, (), (), None  # variable combos: plain path
        # (no latch: encode2 bails at the first mismatching row, and a
        # later batch may well be row-uniform again)
    idx, sizes, combo_row = res
    widths = tuple(
        mi.bit_precision if sizes[j] < 0 else _vocab_width(int(sizes[j]))
        for j in range(W))
    words = (sum(widths) + 31) // 32
    # the real alternative is the combo-broadcast plain pack at
    # bit_precision (combos are row-uniform here, or ship separately) —
    # NOT the wider combo-packed encoding
    if words >= (W * mi.bit_precision + 31) // 32:
        state.disabled = True  # widths only grow: permanent verdict
        return slim, appends, (), (), None
    from .. import native as fw_native

    packed = fw_native.bitpack_mixed(idx, np.array(widths, np.int32), words)
    if packed is None or packed is False:
        state.disabled = packed is None  # no native lib: permanent
        return slim, appends, (), (), None
    bases = []
    off = 0
    for j in range(W):
        if sizes[j] < 0:
            bases.append(-1)
        else:
            bases.append(off)
            off += 1 << widths[j]
    n_rows = (off + 127) // 128
    out = dict(slim)
    out["lr_ids"] = packed
    row_broadcasts = ()
    if combos_packed:
        crow = combo_row.astype(np.int32)
        new_appends = []
        for key, v in appends:
            if key == "lr_ids":
                # the elided constant column's combo joins the broadcast
                # row; its re-appended id sheds the combo bits
                crow = np.append(crow,
                                 np.int32((v >> mi.bit_precision) - 1))
                v = int(v & mi.lr_hash_mask)
            new_appends.append((key, v))
        appends = tuple(new_appends)
        row_broadcasts = (("lr_combos", np.dtype(np.int32).str,
                           tuple(int(x) for x in crow),
                           int(ids.shape[0])),)
    return out, appends, row_broadcasts, (
        ("lr_ids", widths, tuple(bases), n_rows),), (idx, tuple(
            int(s) for s in sizes[:W]))


def export_vocab(venc, spec) -> np.ndarray:
    """Assemble the [n_rows, 128] i32 device vocabulary snapshot for a
    layout's vocab spec (column dictionaries at their region bases)."""
    _key, widths, bases, n_rows = spec
    flat = np.zeros(n_rows * 128, np.int32)
    for j, (w, b) in enumerate(zip(widths, bases)):
        if b < 0:
            continue
        col = venc.export_col(j, 1 << w)
        flat[b:b + len(col)] = col
    return flat.reshape(n_rows, 128)


_TAB_GRAIN = 2048  # tab region rounding: trades re-signature cadence
# against shipped padding. Lifetime bound: a column re-signatures at most
# max_cap/2048 = 8 times before it either saturates or overflows to
# direct (fixed-cardinality schemas saturate in batch 1; steadily-growing
# ones pay <= 8 extra compiles per column, amortized by the persistent
# --fwt_compile_cache)


def table_counts(slim: dict, vocabs: tuple, idx_sizes, row_broadcasts: tuple):
    """Re-encode ``lr_counts`` as a u8 shadow table of the dictionaries.

    Within one batch an id has ONE global multiplicity (the radix counts
    are keyed by the id alone), so for dictionary columns the per-entry
    code is a function of (column, index): ship it once per dictionary
    slot (``lr_counts_tab``) instead of once per example. The tab packs
    columns at their EXACT dictionary sizes rounded to ``_TAB_GRAIN``
    (its own base offsets, carried in the count_tabs spec) — NOT the
    power-of-2 vocab snapshot regions, which ship only on growth and can
    afford the padding; the tab ships EVERY batch (measured Eat-Rate
    schema: 104k real entries vs 172k power-of-2 slots → 3.25 vs 5.25
    B/example). Direct columns keep per-entry codes in a narrowed
    ``lr_counts``.

    Requires exact conditions (checked here; ship per-entry otherwise):
    the value column was elided as all-ones (a zero-valued entry's code
    is 0 regardless of its id, breaking the id→code function) and the
    batch has no padding entries (their code is 0 the same way) — i.e.
    the combo broadcast row is all non-negative."""
    counts = slim.get("lr_counts")
    if idx_sizes is None or not vocabs or counts is None \
            or "lr_vals" in slim or counts.ndim != 2:
        return slim, ()
    idx, sizes = idx_sizes
    if counts.shape != idx.shape or counts.dtype != np.uint8:
        return slim, ()
    for key, _dt, row_vals, _b in row_broadcasts:
        if key == "lr_combos" and any(v < 0 for v in row_vals):
            return slim, ()  # padded batch: codes are 0 at padding
    if "lr_combos" in slim:
        return slim, ()  # combo column shipped raw: padding unknown
    if (counts == counts[0]).all():
        return slim, ()  # row-uniform: broadcast elision is free, a tab
        # would ship the region bytes for nothing (strip_uniform_rows)
    _key, widths, bases, _n_rows = vocabs[0]
    B, W = counts.shape
    tab_bases = []
    off = 0
    for j, b in enumerate(bases):
        if b < 0:
            tab_bases.append(-1)
        else:
            tab_bases.append(off)
            # exact size rounded to the grain, but never beyond the
            # power-of-2 snapshot region (small vocabs stay tiny)
            off += min(1 << widths[j],
                       -(-max(int(sizes[j]), 1) // _TAB_GRAIN) * _TAB_GRAIN)
    off = -(-off // 128) * 128  # [.., 128] device reshape
    n_direct = sum(1 for b in bases if b < 0)
    if off + B * n_direct >= B * W:
        return slim, ()  # tab + direct columns outweigh per-entry codes
        # (large vocab relative to the batch)
    from .. import native as fw_native

    tab = fw_native.counts_table(idx, counts, tab_bases, off)
    if tab is None:
        return slim, ()
    direct = [j for j, b in enumerate(bases) if b < 0]
    out = dict(slim)
    out["lr_counts"] = np.ascontiguousarray(counts[:, direct])
    out["lr_counts_tab"] = tab
    return out, (("lr_counts", "lr_ids", tuple(tab_bases)),)


def prepare_for_transfer(bd: dict, mi, bitpack: bool = True,
                         vocab_state: VocabTransferState | None = None):
    """Production transfer slimming for one full batch: constant-feature
    column elision, combo un-packing to a row broadcast, vocabulary
    index encoding + shadow-table counts (when ``vocab_state`` is
    given), lr/ffm id bit-packing, uniform-row elision (field
    indices, combo indices, multiplicity counts), and 1-bit label
    packing. Returns (slim, appends, bitpacks, row_broadcasts, vocabs,
    count_tabs, bit_cols) — the layout_of inputs. Used by the train loop's producer and by bench.py's
    transfer probes so measurements ship the production payload."""
    slim, appends = strip_constant_columns(bd, mi.lr_hash_mask)
    bitpacks = ()
    row_broadcasts = ()
    vocabs = ()
    count_tabs = ()
    if bitpack:
        if vocab_state is not None:
            slim, appends, rb0, vocabs, idx_sizes = encode_vocab_ids(
                slim, appends, mi, vocab_state)
            row_broadcasts += rb0
            if vocabs:
                slim, count_tabs = table_counts(slim, vocabs, idx_sizes,
                                                row_broadcasts)
        if not vocabs:
            slim, appends, rb0 = unpack_uniform_combos(slim, appends, mi)
            row_broadcasts += rb0
            shift_bits = (mi.num_combos + 1).bit_length()
            combos_out = "lr_combos" in slim or any(
                r[0] == "lr_combos" for r in row_broadcasts)
            if not combos_out and mi.bit_precision + shift_bits <= 31:
                id_bits = mi.bit_precision + shift_bits
            else:
                id_bits = mi.bit_precision
            slim, bitpacks = bitpack_ids(slim, "lr_ids", id_bits)
        if getattr(mi, "ffm_k", 0) > 0 and "ffm_ids" in slim:
            # ffm ids are the raw hash masked to 2^ffm_bit_precision
            # (native/fw_core.h translate_record; padding entries are 0)
            slim, bp2 = bitpack_ids(slim, "ffm_ids", mi.ffm_bit_precision)
            bitpacks = bitpacks + bp2
    for key in ("ffm_fields", "lr_combos", "lr_counts", "ffm_counts"):
        if count_tabs and key == "lr_counts":
            continue  # narrowed direct-column array: unpack needs it
        slim, rb = strip_uniform_rows(slim, key)
        row_broadcasts = row_broadcasts + rb
    bit_cols = ()
    if bitpack:
        slim, bit_cols = bitpack_labels(slim)
    return (slim, appends, bitpacks, row_broadcasts, vocabs, count_tabs,
            bit_cols)


class PreparedBatch:
    """A full batch already in wire form (the fused C emit path): ``slim``
    is the transfer dict and ``lay`` its :class:`PackedLayout` — the
    producer appends it to the current group directly, skipping
    :func:`prepare_for_transfer`."""

    __slots__ = ("slim", "lay")

    def __init__(self, slim: dict, lay: PackedLayout):
        self.slim = slim
        self.lay = lay


def try_fused_emit(ni, start: int, B: int, W_all: int, mi,
                   state: VocabTransferState, with_counts: bool,
                   ffm_pad_width: int = 0, ffm_count_shift=None):
    """Steady-state fused emit of one FULL batch: translated SoA →
    final wire arrays in one native sweep (fwn_emit_fused), byte-identical
    to the prepare_for_transfer chain (asserted in tests/test_fused_emit).

    The layout (per-column wire widths, vocab snapshot regions, count-tab
    bases) is derived here from the PRE-batch dictionary state; the native
    sweep bails on anything that could change it (a mint, an overflow, a
    variable-width example, a non-uniform combo row, labels outside {0,1},
    row-uniform counts), in which case this returns None and the caller
    falls back to the general path — which re-encodes idempotently.

    Caller contract (checked by the producer's hook, not here): full
    batch, LR-only schema, lr values and importances proven all-ones,
    count key = raw id (shift 0). Returns (slim, layout) or None."""
    if state is None or state.disabled:
        return None
    shift_bits = (mi.num_combos + 1).bit_length()
    if mi.bit_precision + shift_bits > 31 or B % 32 or B <= 0:
        return None
    W = W_all - 1
    if W < 1:
        return None
    # read-only peek at the encoder: encoder_for() owns the deferred
    # grow/recreate protocol and must be called exactly ONCE per batch
    # (by the general path) — a second call in the same batch would
    # recreate the dictionaries while a pending group still needs the old
    # ones for its snapshot export. A missing or too-narrow encoder means
    # this batch belongs to the general path anyway.
    venc = state.venc
    if venc is None or venc.n_cols < W or state._grow_to:
        return None
    widths = np.empty(W, np.int32)
    bases = []
    sizes = []
    n_direct = 0
    off = 0
    for j in range(W):
        if venc.col_direct(j):
            widths[j] = mi.bit_precision
            bases.append(-1)
            sizes.append(-1)
            n_direct += 1
        else:
            s = venc.col_size(j)
            if s <= 0:
                return None  # unseen column: the first batch must mint
            widths[j] = _vocab_width(s)
            bases.append(off)
            off += 1 << int(widths[j])
            sizes.append(s)
    words = (int(widths.sum()) + 31) // 32
    if words >= (W * mi.bit_precision + 31) // 32:
        return None  # no whole-word saving: the general path latches off
    n_rows = (off + 127) // 128
    tab_bases = None
    tab_len = -1
    if with_counts:
        tab_bases = np.empty(W, np.int32)
        toff = 0
        for j in range(W):
            if bases[j] < 0:
                tab_bases[j] = -1
            else:
                tab_bases[j] = toff
                toff += min(1 << int(widths[j]),
                            -(-max(sizes[j], 1) // _TAB_GRAIN) * _TAB_GRAIN)
        toff = -(-toff // 128) * 128
        if toff + B * n_direct >= B * W:
            return None  # per-entry codes are smaller (table_counts)
        tab_len = toff
    # FFM columns: the wire shape is the stream's PADDED width; the ids
    # column ships bit-packed only when that saves a whole u32 word per
    # row (bitpack_ids' rule), else raw i32 — byte-identical either way
    n_ffm = int(ffm_pad_width)
    ffm_bits = fwords = 0
    ffm_packed = False
    out_ffm_ids = out_ffm_counts = ffm_field_row = None
    fshift = -1
    if n_ffm > 0:
        if getattr(mi, "ffm_k", 0) <= 0:
            return None
        fb = mi.ffm_bit_precision
        fwords = (n_ffm * fb + 31) // 32
        ffm_packed = fb <= 31 and fwords < n_ffm
        if ffm_packed:
            ffm_bits = fb
        else:
            fwords = n_ffm
        out_ffm_ids = np.empty(
            (B, fwords), np.uint32 if ffm_packed else np.int32)
        ffm_field_row = np.empty(n_ffm, np.int32)
        if ffm_count_shift is not None:
            fshift = int(ffm_count_shift)
            out_ffm_counts = np.empty((B, n_ffm), np.uint8)

    out_ids = np.empty((B, words), np.uint32)
    out_label = np.empty(B // 32, np.uint32)
    out_tab = np.empty(tab_len, np.uint8) if with_counts else None
    out_direct = np.empty((B, n_direct), np.uint8) if with_counts else None
    combo_row = np.empty(W_all, np.int32)
    const_code = np.zeros(1, np.int32)
    const_id = CONSTANT_HASH & mi.lr_hash_mask
    if not ni.emit_fused(venc, start, B, W_all, const_id, widths, tab_bases,
                         words, tab_len, n_direct, out_ids.reshape(-1),
                         out_tab,
                         None if out_direct is None
                         else out_direct.reshape(-1),
                         out_label, combo_row, const_code,
                         n_ffm_pad=n_ffm, ffm_bits=ffm_bits,
                         ffm_words=fwords, ffm_shift=fshift,
                         out_ffm_ids=None if out_ffm_ids is None
                         else out_ffm_ids.reshape(-1).view(np.uint32),
                         out_ffm_counts=None if out_ffm_counts is None
                         else out_ffm_counts.reshape(-1),
                         ffm_field_row=ffm_field_row):
        return None
    slim = {"label": out_label, "lr_ids": out_ids}
    bitpacks = ()
    if n_ffm > 0:
        slim["ffm_ids"] = out_ffm_ids
        if ffm_packed:
            bitpacks = (("ffm_ids", ffm_bits, n_ffm),)
        if out_ffm_counts is not None:
            slim["ffm_counts"] = out_ffm_counts
    else:
        # zero-byte FFM placeholders: fill_range always materializes them
        # for LR-only schemas and slim keeps them, so they are part of the
        # general path's layout signature — the fused layout must match it
        # exactly or fused and general batches would split superbatch
        # groups
        slim["ffm_fields"] = np.empty((B, 0), np.int8)
        slim["ffm_ids"] = np.empty((B, 0), np.int32)
        slim["ffm_vals"] = np.empty((B, 0), np.float32)
    appends = [("lr_ids", const_id)]
    if with_counts:
        slim["lr_counts"] = out_direct
        slim["lr_counts_tab"] = out_tab
        appends.append(("lr_counts", int(const_code[0])))
    row_broadcasts = (("lr_combos", np.dtype(np.int32).str,
                       tuple(int(x) for x in combo_row), B),)
    if n_ffm > 0:
        # same append order as prepare_for_transfer's strip_uniform_rows
        # loop: lr_combos (from the vocab encode) first, then ffm_fields
        row_broadcasts += (("ffm_fields", np.dtype(np.int8).str,
                            tuple(int(x) for x in ffm_field_row), B),)
    vocabs = (("lr_ids", tuple(int(x) for x in widths), tuple(bases),
               n_rows),)
    count_tabs = ((("lr_counts", "lr_ids",
                    tuple(int(x) for x in tab_bases)),)
                  if with_counts else ())
    lay = layout_of(slim, tuple(appends), bitpacks, row_broadcasts, vocabs,
                    count_tabs, (("label", B),))
    if lay is None:
        return None
    return PreparedBatch(slim, lay)


def pack(layout: PackedLayout, bds: list) -> np.ndarray:
    """K batch dicts → [K, words] u32 (one flat memcpy per array)."""
    buf = np.empty((len(bds), layout.words), np.uint32)
    for k, bd in enumerate(bds):
        row = buf[k]
        for f in layout.fields:
            row[f.word_off : f.word_off + f.word_len] = (
                bd[f.key].reshape(-1).view(np.uint32)
            )
    return buf


def unpack_row(row: jnp.ndarray, layout: PackedLayout,
               vocab: jnp.ndarray | None = None) -> dict:
    """Device-side inverse of :func:`pack` for one row — static slices +
    bitcasts, fused into the consuming step by XLA (no extra HBM passes).
    ``vocab`` is the [n_rows, 128] i32 dictionary snapshot, required when
    the layout carries a vocab spec."""
    bd = {}
    for f in layout.fields:
        seg = jax.lax.slice(row, (f.word_off,), (f.word_off + f.word_len,))
        dt = np.dtype(f.dtype)
        jdt = _DTYPES[dt]
        if dt.itemsize == 4:
            arr = jax.lax.bitcast_convert_type(seg, jdt)
        else:
            # u32 [n] → [n, 4/itemsize] of the narrow type → flat
            arr = jax.lax.bitcast_convert_type(seg, jdt).reshape(-1)
        bd[f.key] = arr.reshape(f.shape)
    lanes = jnp.arange(128, dtype=jnp.int32)[None, :]

    def _tab_select(tab2d, flat):
        # flat index → value via row gather + integer lane select, the
        # tables' row layout (ops/tables.py); a one-hot f32 contraction
        # would lose 25-bit ids past 2^24
        rows = jnp.take(tab2d, flat >> 7, axis=0)  # [B, 128]
        return jnp.sum(
            jnp.where((flat & 127)[:, None] == lanes, rows, 0),
            axis=1, dtype=jnp.int32)

    vocab_idx = {}  # key → per-column raw index/id vectors (pre-gather)
    for key, widths, bases, _n_rows in layout.vocabs:
        a = bd[key]  # [B, words] u32
        cols = []
        idxs = []
        o = 0
        for wbits, base in zip(widths, bases):
            w0, s = o // 32, o % 32
            v = jax.lax.shift_right_logical(a[:, w0], jnp.uint32(s))
            if s + wbits > 32:
                v = v | jax.lax.shift_left(a[:, w0 + 1], jnp.uint32(32 - s))
            v = (v & jnp.uint32((1 << wbits) - 1)).astype(jnp.int32)
            idxs.append(v)
            if base >= 0:
                v = _tab_select(vocab, v + jnp.int32(base))
            cols.append(v)
            o += wbits
        bd[key] = jnp.stack(cols, axis=1)
        vocab_idx[key] = (idxs, bases)
    for spec in layout.count_tabs:
        # multiplicity codes: dictionary columns read the u8 shadow table
        # at their packed tab slot (tab bases in the spec; a 2-tuple spec
        # without them — hand-built layouts — reuses the vocab bases; v1
        # pack caches are version-rejected before reaching here);
        # direct columns take the next per-entry column of the narrowed
        # ckey array (see table_counts)
        ckey, idkey = spec[0], spec[1]
        idxs, bases = vocab_idx[idkey]
        tab_bases = spec[2] if len(spec) > 2 else bases
        tab2d = bd.pop(ckey + "_tab").reshape(-1, 128)
        direct = bd[ckey]  # [B, D] u8
        cols = []
        d = 0
        for j, base in enumerate(tab_bases):
            if base < 0:
                cols.append(direct[:, d].astype(jnp.int32))
                d += 1
            else:
                cols.append(_tab_select(tab2d, idxs[j] + jnp.int32(base)))
        bd[ckey] = jnp.stack(cols, axis=1).astype(jnp.uint8)
    for key, bits, W in layout.bitpacks:
        # static shifts/masks per column — XLA fuses these into the step
        a = bd[key]  # [B, words] u32
        mask = jnp.uint32((1 << bits) - 1)
        cols = []
        for j in range(W):
            o = j * bits
            w0, s = o // 32, o % 32
            v = jax.lax.shift_right_logical(a[:, w0], jnp.uint32(s))
            if s + bits > 32:
                v = v | jax.lax.shift_left(a[:, w0 + 1], jnp.uint32(32 - s))
            cols.append((v & mask).astype(jnp.int32))
        bd[key] = jnp.stack(cols, axis=1)
    for key, n in layout.bit_cols:
        # 1-bit columns (label): [n/32] u32 → [n] u8 by broadcast
        # shift/mask — no gather, fuses into the consuming step
        words = bd[key]
        shifts = jnp.arange(32, dtype=jnp.uint32)[None, :]
        bits = jax.lax.shift_right_logical(words[:, None], shifts)
        bd[key] = (bits & jnp.uint32(1)).reshape(n).astype(jnp.uint8)
    for key, dtstr, row_vals, B in layout.row_broadcasts:
        row = jnp.asarray(np.array(row_vals, np.dtype(dtstr)))
        bd[key] = jnp.broadcast_to(row, (B, len(row_vals)))
    for key, value in layout.appends:
        a = bd[key]
        col = jnp.full((a.shape[0], 1), value, a.dtype)
        bd[key] = jnp.concatenate([a, col], axis=1)
    return bd


def make_packed_train_step(model, layout: PackedLayout, K: int):
    """(params, buf [K, words] u32[, vocab]) → (params, preds [K, B]).

    Runs K sequential train steps (identical math to the per-batch step —
    the raw step body is shared) inside one jit; params are donated so the
    tables update in place. When the layout carries a vocab spec the
    jitted step takes the [n_rows, 128] i32 snapshot as a third,
    non-donated argument (constant across the scan).
    """
    key = ("packed", layout.signature, K)
    cache = getattr(model, "_packed_steps", None)
    if cache is None:
        cache = model._packed_steps = {}
    if key in cache:
        return cache[key]

    from .step import make_train_step

    make_train_step(model)  # ensure the raw body exists
    inner = model._train_step_raw

    if layout.vocabs:
        def packed_steps(params, buf, vocab):
            def body(p, row):
                return inner(p, unpack_row(row, layout, vocab))
            return jax.lax.scan(body, params, buf)
    else:
        def packed_steps(params, buf):
            def body(p, row):
                return inner(p, unpack_row(row, layout))
            return jax.lax.scan(body, params, buf)

    jitted = jax.jit(packed_steps, donate_argnums=(0,))
    cache[key] = jitted
    return jitted


def make_packed_train_step_ring(model, layout, K: int, M: int):
    """(params, buf [K, words] u32, ring [M, K, B], slot) → (params, ring).

    Identical math to :func:`make_packed_train_step`, but the superbatch's
    predictions land in row ``slot`` of a device-resident ring instead of a
    per-call output; the caller fetches the ring ONCE per M superbatches.
    On a high-latency host↔device link the D2H fetch is latency-bound and a
    fetch waiting on an unfinished step can hold up the next transfer — the
    ring cuts fetch calls M× with ZERO extra dispatches. The ring is not
    donated: the previous flush's array stays valid for the writer thread
    while later steps build the next one (one [M, K, B] device copy per
    step).
    """
    key = ("packed_ring", layout.signature, K, M)
    cache = getattr(model, "_packed_steps", None)
    if cache is None:
        cache = model._packed_steps = {}
    if key in cache:
        return cache[key]

    from .step import make_train_step

    make_train_step(model)  # ensure the raw body exists
    inner = model._train_step_raw

    def _scan(params, buf, vocab):
        def body(p, row):
            return inner(p, unpack_row(row, layout, vocab))
        return jax.lax.scan(body, params, buf)

    def _finish(params, preds, ring, slot):
        ring = jax.lax.dynamic_update_slice(
            ring, preds[None].astype(ring.dtype), (slot, 0, 0))
        return params, ring

    if layout.vocabs:
        def packed_steps_ring(params, buf, ring, slot, vocab):
            return _finish(*_scan(params, buf, vocab), ring, slot)
    else:
        def packed_steps_ring(params, buf, ring, slot):
            return _finish(*_scan(params, buf, None), ring, slot)

    jitted = jax.jit(packed_steps_ring, donate_argnums=(0,))
    cache[key] = jitted
    return jitted
