"""The benchmark's weights: drawn from the seed on the device, in a few
large calls, by the ``init`` rules of a configuration file.

A rule is ``{"match": <regex on the leaf's path>, "init": <kind>, ...}``;
the first rule that matches a path sets its leaf:

  * ``normal``: a normal draw times ``std``, a number or ``"fan_in"``
    (the leaf's second-to-last size to the power −1/2: a linear weight's
    d_in, a conv's width);
  * ``const``: ``value`` everywhere;
  * ``log_uniform``: ``log(u)``, u uniform in [lo, hi] (Mamba2's A);
  * ``softplus_inverse``: the inverse softplus of a log-uniform draw in
    [lo, hi] (Mamba2's dt bias).

A rule's ``serve`` names the dtype the leaf is served in; ``dtype``
leaves are made in ``"float32"`` for training.  Every normal draw of one
dtype comes from one call, every uniform draw from one, in path order,
so a seed gives the same weights on any run and to either side.
"""
from __future__ import annotations

import math
import re

import torch


def rule_for(path: str, rules) -> dict:
    for rule in rules:
        if re.search(rule["match"], path):
            return rule
    raise KeyError(f"no init rule matches the leaf {path!r}")


def make(shapes: dict, rules, seed: int, device, *, serve: bool = False):
    """``{path: tensor}`` for ``shapes`` (``{path: shape}``) from
    ``seed``: float32, or each leaf in its rule's ``serve`` dtype where
    ``serve``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    plan = {}
    for path, shape in shapes.items():
        rule = rule_for(path, rules)
        dtype = getattr(torch, rule.get("serve", "float32")
                        if serve else "float32")
        plan[path] = (rule, tuple(shape), dtype)
    out = {}
    # one normal call a dtype, one uniform call, in path order
    for dtype in sorted({d for r, _, d in plan.values()
                         if r["init"] == "normal"}, key=str):
        paths = [p for p, (r, _, d) in plan.items()
                 if r["init"] == "normal" and d == dtype]
        flat = torch.randn(sum(math.prod(plan[p][1]) for p in paths),
                           generator=g, device=device, dtype=dtype)
        at = 0
        for p in paths:
            rule, shape, _ = plan[p]
            n = math.prod(shape)
            std = rule["std"]
            if std == "fan_in":
                std = shape[-2] ** -0.5
            out[p] = flat[at:at + n].view(shape).mul_(std)
            at += n
    uni = [p for p, (r, _, _) in plan.items()
           if r["init"] in ("log_uniform", "softplus_inverse")]
    if uni:
        flat = torch.rand(sum(math.prod(plan[p][1]) for p in uni),
                          generator=g, device=device, dtype=torch.float64)
        at = 0
        for p in uni:
            rule, shape, dtype = plan[p]
            n = math.prod(shape)
            u = flat[at:at + n].view(shape)
            at += n
            lo, hi = math.log(rule["lo"]), math.log(rule["hi"])
            if rule["init"] == "log_uniform":
                val = torch.log(rule["lo"] + u * (rule["hi"] - rule["lo"]))
            else:
                dt = torch.exp(lo + u * (hi - lo))
                val = dt + torch.log(-torch.expm1(-dt))   # softplus⁻¹
            out[p] = val.to(dtype)
    for p, (rule, shape, dtype) in plan.items():
        if rule["init"] == "const":
            out[p] = torch.full(shape, float(rule["value"]), dtype=dtype,
                                device=device)
        elif rule["init"] not in ("normal", "log_uniform",
                                  "softplus_inverse"):
            raise ValueError(f"unknown init {rule['init']!r} for {p!r}")
    return {p: out[p] for p in shapes}


def nest(flat: dict) -> dict:
    """``{"a/b/c": t}`` → ``{"a": {"b": {"c": t}}}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def flatten(tree, prefix: str = "") -> dict:
    """The inverse of :func:`nest` over nested dicts of tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out
