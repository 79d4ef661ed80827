"""Where the harness meets the program (`arec_torch`): the configuration
as the program takes it, and the program's state leaves by the
reference's names. Every name of the program the harness reaches is
imported in the drivers or here."""

from __future__ import annotations

import json
import os
import tempfile

from reference.model import BATCH_LOSSES


def config(cell, seed: int):
    """The program's Config for a run: the file's `config` section, with
    the prepared-data cache in the checkout, the run's seed, and a
    training directory of this process under TMPDIR that nothing is saved
    into (the Trainer makes it; the training driver removes it)."""
    from arec_torch.config import Config

    from harness.bench import CACHE

    body = dict(cell.config["config"])
    data = {**body["data"], "data_dir": os.path.join(CACHE, "data")}
    train = {**body["train"], "seed": seed,
             "train_dir": os.path.join(tempfile.gettempdir(),
                                       f"bench-train-{os.getpid()}")}
    return Config.from_json(json.dumps({**body, "data": data,
                                        "train": train}))


def family(cfg) -> str:
    return "seq" if cfg.model.model == "lstm" else "mf"


def rnn_cell(cfg) -> str | None:
    """The recurrent cell of a sequence configuration (`model.cell`:
    "lstm" or "gru"), None for MF. The one place the harness reads it:
    the weights' shapes, the reference's recurrence and the FLOP counts
    all take it from here."""
    return cfg.model.cell if family(cfg) == "seq" else None


# the losses benchmark/reference implements, by family
REFERENCE_LOSSES = {"mf": ("ce", *BATCH_LOSSES), "seq": ("ce",)}


def mf_loss(cfg) -> tuple[str, bool]:
    """(the training loss, whether its in-batch proposal is
    Horvitz–Thompson corrected): ("ce" | "mw" | "bbpr", batch_ht) for MF,
    ("ce", False) for a sequence configuration. The one place the harness
    reads `train.loss` and `train.batch_ht`: the reference's loss, the
    controls and the FLOP counts all take it from here. A loss that the
    reference does not implement raises, so that no configuration is held
    to a loss it does not train."""
    fam, loss, ht = family(cfg), cfg.train.loss, bool(cfg.train.batch_ht)
    known = REFERENCE_LOSSES[fam]
    if loss not in known:
        raise ValueError(
            f"train.loss {loss!r}: the benchmark's reference has no "
            f"{loss!r} loss for the {fam} family (it has "
            f"{', '.join(known)})")
    if ht and loss not in BATCH_LOSSES:
        raise ValueError(
            f"train.batch_ht with train.loss {loss!r}: only the in-batch "
            f"losses {', '.join(BATCH_LOSSES)} take it")
    return loss, ht


def leaves(state, fam: str, sparse: bool) -> dict:
    """{reference leaf name: (param tensor, Adagrad accumulator)} of the
    program's TrainState: a sparse step's table is packed [V, 2W] (param
    half, accumulator half) and its other leaves' accumulators sit under
    opt_state["rest"]."""
    fused = "__fused__"
    p = state.params
    acc = (state.opt_state["rest"]["sum_of_squares"] if sparse
           else state.opt_state["sum_of_squares"])
    out = {}
    encs = ("user", "item") if fam == "mf" else ("item_in",)
    for e in encs:
        t = p[e]["tables"][fused]
        if sparse:
            w = t.shape[1] // 2
            out[f"{e}.table"] = (t[:, :w], t[:, w:])
        else:
            out[f"{e}.table"] = (t, acc[e]["tables"][fused])
        for k in ("w1", "b1"):
            out[f"{e}.{k}"] = (p[e]["fusion"][k], acc[e]["fusion"][k])
    if fam == "seq":
        layer, lacc = p["rnn"][0], acc["rnn"][0]
        out["rnn_w"] = (layer["w"], lacc["w"])
        out["rnn_b"] = (layer["b"], lacc["b"])
        if sparse:
            t = p["item_out"]
            w = t.shape[1] // 2
            out["item_out"] = (t[:, :w], t[:, w:])
        else:
            out["item_out"] = (p["item_out"], acc["item_out"])
    return out


def rules(names, sparse: bool) -> dict:
    """{leaf name: Adagrad rule}: a sparse step's tables take the
    touched-rows form ("sparse"), every other leaf the dense one. The one
    place the rule is decided, for the driver and the controls alike."""
    return {k: "sparse" if sparse and (k.endswith(".table")
                                       or k == "item_out") else "dense"
            for k in names}


def param_tree(fam: str, w: dict) -> dict:
    """The program's (arec-layout) param tree of flat weights `w`."""
    fused = "__fused__"
    tree = {}
    encs = ("user", "item") if fam == "mf" else ("item_in",)
    for e in encs:
        tree[e] = {"tables": {fused: w[f"{e}.table"]},
                   "fusion": {"w1": w[f"{e}.w1"], "b1": w[f"{e}.b1"]}}
    if fam == "seq":
        tree["rnn"] = [{"w": w["rnn_w"], "b": w["rnn_b"]}]
        tree["item_out"] = w["item_out"]
    return tree
