"""Auto-mode interaction matrix: five adaptive producer subsystems — vocab
dictionary encoding (incl. the mid-run auto-flip), id bit-packing,
superbatching, the fetch ring, the batch-mean multiplicity cap — and the
pack-cache replay interact inside one producer
(train/loop.py), each individually identity-tested but previously never
swept in combination. Every combination must be byte-identical to the
plain unpacked path: all of them are pure TRANSFER/DISPATCH re-encodings,
not semantics.

CI runs a pairwise-covering subset; set FWT_FULL_MATRIX=1 to sweep the
full cross product (nightly-style).
"""

import itertools
import os
import shutil

import pytest

from tests.test_end_to_end import FLAGS, gen_dataset, run_cli

# axes: (flag-fragment builder, values). `ring` uses --fwt_fetch_stack
# (0 = per-step async fetch, 4 = device ring, one D2H per 4 superbatches);
# `vocab` "flip" = auto mode with FWT_VOCAB_FLIP=force (the encoder
# one-way-disables mid-run, re-signaturing the layout).
AXES = {
    "vocab": ["on", "off", "flip"],
    "bitpack": ["on", "off"],
    "superbatch": ["1", "8"],
    "ring": ["0", "4"],
    "batch_mean": ["on", "auto"],
    "pack_cache": ["off", "replay"],
}

# pairwise-ish CI subset: every axis exercises all its values, and the
# riskiest pairs (vocab-flip x pack-cache replay, ring x superbatch,
# vocab x ring x replay) appear with internally CONSISTENT flag values —
# vocab needs bitpack on (loop.py only creates VocabTransferState then),
# and superbatch 1 disables packing/ring/pack-cache entirely (kept as one
# deliberate graceful-degradation combo, labeled as such)
CI_COMBOS = [
    dict(zip(AXES, vals))
    for vals in [
        ("on", "on", "8", "0", "on", "off"),       # all-packed default
        ("off", "off", "1", "0", "on", "off"),     # plainest, no pack
        ("flip", "on", "8", "4", "auto", "off"),   # flip x ring
        ("flip", "on", "8", "0", "on", "replay"),  # flip x replay
        ("on", "on", "8", "0", "auto", "off"),     # vocab x auto batch_mean
        ("on", "on", "8", "4", "auto", "replay"),  # vocab x ring x replay
        ("off", "on", "1", "4", "on", "replay"),   # degenerate: K=1
        # disables packing, so ring/replay must gracefully no-op
    ]
]

if os.environ.get("FWT_FULL_MATRIX") == "1":
    COMBOS = [dict(zip(AXES, vals))
              for vals in itertools.product(*AXES.values())]
else:
    COMBOS = CI_COMBOS


def _argv(combo: dict, data, preds, model):
    argv = FLAGS + ["--data", str(data), "-p", str(preds), "-f", str(model),
                    "--save_resume"]
    argv += ["--fwt_vocab",
             "auto" if combo["vocab"] == "flip" else combo["vocab"]]
    argv += ["--fwt_bitpack", combo["bitpack"]]
    argv += ["--fwt_superbatch", combo["superbatch"]]
    argv += ["--fwt_fetch_stack", combo["ring"]]
    argv += ["--fwt_batch_mean", combo["batch_mean"]]
    if combo["pack_cache"] == "replay":
        argv += ["--fwt_pack_cache", "on"]
    else:
        argv += ["--fwt_pack_cache", "off"]
    return argv


@pytest.fixture(scope="module")
def matrix_env(tmp_path_factory):
    from fwumious_wabbit_tpu import native

    if native.load() is None:
        pytest.skip("no native toolchain")
    d = tmp_path_factory.mktemp("auto_matrix")
    # small but multi-superbatch: B=256 (FLAGS), so 8 x 256 = 2048/group
    gen_dataset(d, n_train=6000, n_eval=10)
    # baseline: the plain unpacked path — no slimming, no superbatch, no
    # ring, explicit batch_mean on (auto resolves to on for
    # this power_t 0 config; asserting both keeps the oracle unambiguous)
    preds, model = d / "base.preds", d / "base.model"
    run_cli(FLAGS + ["--data", str(d / "train.vw"), "-p", str(preds),
                     "-f", str(model), "--save_resume",
                     "--fwt_vocab", "off", "--fwt_bitpack", "off",
                     "--fwt_superbatch", "1", "--fwt_fetch_stack", "0",
                     "--fwt_batch_mean", "on",
                     "--fwt_pack_cache", "off"])
    return d, preds.read_text(), model.read_bytes()


@pytest.mark.parametrize(
    "combo", COMBOS,
    ids=["-".join(f"{k[:2]}{v}" for k, v in c.items()) for c in COMBOS])
def test_auto_mode_matrix(matrix_env, combo, tmp_path, monkeypatch):
    d, base_preds, base_model = matrix_env
    if combo["vocab"] == "flip":
        monkeypatch.setenv("FWT_VOCAB_FLIP", "force")
    else:
        monkeypatch.setenv("FWT_VOCAB_FLIP", "off")

    # pack-cache replay: private copy of the dataset (the .fwpack sits
    # beside the data file), record pass then replay pass — BOTH compared
    data = d / "train.vw"
    if combo["pack_cache"] == "replay":
        data = tmp_path / "train.vw"
        shutil.copy(d / "train.vw", data)
        shutil.copy(d / "vw_namespace_map.csv",
                    tmp_path / "vw_namespace_map.csv")

    preds, model = tmp_path / "m.preds", tmp_path / "m.model"
    argv = _argv(combo, data, preds, model)
    run_cli(argv)
    assert preds.read_text() == base_preds, "record/live pass diverged"
    assert model.read_bytes() == base_model

    if combo["pack_cache"] == "replay":
        preds2, model2 = tmp_path / "r.preds", tmp_path / "r.model"
        run_cli(_argv(combo, data, preds2, model2))
        assert preds2.read_text() == base_preds, "replay pass diverged"
        assert model2.read_bytes() == base_model
