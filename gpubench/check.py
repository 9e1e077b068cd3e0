"""How ``correct`` is decided: what the timed path produced, held against
the plain reference on the same inputs, number by number, each against
its limit in the cell's ``workloads/<cell>.json``.

Training (entry ``train``): the program's first ``checked_steps`` steps
ran in set-up through the window's own step function and feed; the
reference follows them from the same weights and batches.  Compared:
  * ``loss_gap``: every step's and node's loss, |program − reference| /
    |reference|, the worst;
  * ``grad_norm_gap``: the first step's gradient as the optimizer got it
    (AdamW's first moment after one step over 1 − β₁), the norm of each
    leaf of each node (a stacked layer's slice is a leaf), |‖program‖ −
    ‖reference‖| / max(‖reference‖, the median leaf's), the worst;
  * ``change_norm_gap``: the same of each leaf's change over the checked
    steps.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's move under Adam by rounding alone and are left out of both.

Prefill (entry ``prefill``): a sample of the window's answers drawn from
the seed as they came (the driver keeps no others), each the
last-position logits of one prompt.  Compared, the
worst over the sample:
  * ``greedy_gap``: how far the reference's logit of the token the
    program puts first lies below the reference's best;
  * ``logit_rel_l2``: ‖program − reference‖ / ‖reference‖;
  * ``top_logit_err``: the largest |program − reference| over the
    program's ``TOP`` first tokens, over the reference logits' RMS: an
    answer whose leading tokens are wrong, even where the best one is
    right.
A cell compares the numbers its file gives a limit; the others are
printed, not judged (a greedy gap over one prompt a run has no reading
from the control: FP8 seldom moves the best token of one prompt).
"""
from __future__ import annotations

import importlib
import math
import statistics

import torch

from gpubench import generator, weights as W

NEGLIGIBLE = 1e-3          # of the median leaf's gradient norm
TOP = 8                    # leading tokens of an answer top_logit_err reads


def reference(config: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"gpubench.reference.{config['reference']}")


# ------------------------------------------------------------- leaves

def layer_axes(flat: dict, path: str) -> int:
    """How many layer axes follow the node axis in a stacked leaf: a
    segment's (``seg<i>/…``) as many as its norm has before d, else 0."""
    head = path.split("/")[0]
    if head.startswith("seg") and f"{head}/norm1/scale" in flat:
        return flat[f"{head}/norm1/scale"].dim() - 2
    return 0


def slice_norms(flat: dict, scale: float = 1.0, minus: dict | None = None):
    """{``path[node, layer…]``: norm} of every leaf slice of a node-stacked
    flat tree, times ``scale``; of ``flat − minus`` where ``minus`` (the
    same tree without the node axis) is given."""
    names, norms = [], []
    for path, t in flat.items():
        lead = 1 + layer_axes(flat, path)
        x = t.float()
        if minus is not None:
            x = x - minus[path].float()
        rows = x.reshape(math.prod(t.shape[:lead]), -1)
        norms.append(torch.linalg.vector_norm(rows, dim=1) * scale)
        for idx in _indices(t.shape[:lead]):
            names.append(f"{path}{list(idx)}")
        del x, rows
    values = torch.cat(norms).tolist()
    return dict(zip(names, values, strict=True))


def _indices(shape):
    if not shape:
        yield ()
        return
    for i in range(shape[0]):
        for rest in _indices(shape[1:]):
            yield (i, *rest)


def norm_gap(got: dict, want: dict, keep) -> float:
    """max over ``keep`` of |got − want| / max(want, the median want)."""
    median = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in keep)


def kept(ref_grads: dict):
    median = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= NEGLIGIBLE * median]


# ------------------------------------------------------------- training

def train_readings(losses, first_grads: dict, params: dict, params0: dict):
    """The reference's numbers: losses [step][node], each leaf slice's
    first gradient norm and change norm."""
    return {"losses": [list(map(float, s)) for s in losses],
            "grad_norms": slice_norms(first_grads),
            "change_norms": slice_norms(params, minus=params0)}


def compare_train(got: dict, want: dict) -> dict:
    keep = kept(want["grad_norms"])
    loss = max(abs(g - w) / abs(w)
               for gs, ws in zip(got["losses"], want["losses"], strict=True)
               for g, w in zip(gs, ws, strict=True))
    return {"loss_gap": loss,
            "grad_norm_gap": norm_gap(got["grad_norms"], want["grad_norms"],
                                      keep),
            "change_norm_gap": norm_gap(got["change_norms"],
                                        want["change_norms"], keep)}


def reference_train(config, traffic, shapes, seed, device,
                    precision="float32"):
    """The reference's readings over the checked steps, from the seed."""
    model = config["model"]
    params0 = W.make(shapes, config["init"], seed, device)
    feed = generator.Feed(traffic, model["vocab_size"], seed, device)
    batches = [feed.next() for _ in range(traffic["checked_steps"])]
    losses, g1, params = reference(config).train(params0, batches, model,
                                                 traffic, precision)
    out = train_readings(losses, g1, params, params0)
    del g1, params, params0
    return out


# ------------------------------------------------------------- prefill

def logit_numbers(got, ref) -> tuple[float, float, float]:
    """(greedy gap, relative L2, top-token error) of one answer ``got``
    against the reference's logits ``ref``."""
    got, ref = got.float(), ref.float()
    gap = float(ref.max() - ref[int(torch.argmax(got))])
    rel = float(torch.linalg.vector_norm(got - ref)
                / torch.linalg.vector_norm(ref))
    top = torch.topk(got, TOP).indices
    err = float((got[top] - ref[top]).abs().max()
                / torch.sqrt(torch.mean(ref * ref)))
    return gap, rel, err


def compare_prefill(config, rows, shapes, seed, device, precision=None):
    """The worst greedy gap, relative L2 and top-token error over
    ``rows`` ([(tokens (S,), logits (V,))]: the answers the run kept);
    with ``precision``, the reference in that precision stands in for
    the program (the control) and the rows' logits are not read."""
    model = config["model"]
    params = W.make(shapes, config["init"], seed, device, serve=True)
    ref = reference(config)
    out = []
    for tokens, logits in rows:
        want = ref.last_logits(params, tokens, model, "float32")
        got = (logits if precision is None
               else ref.last_logits(params, tokens, model, precision))
        out.append(logit_numbers(got, want))
    return {name: max(row[i] for row in out) for i, name in
            enumerate(("greedy_gap", "logit_rel_l2", "top_logit_err"))}


# ------------------------------------------------------------- limits

def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that has a limit finite and within it, {name: {value,
    limit}} of those)."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        table[name] = {"value": value, "limit": limit}
    return ok, table
