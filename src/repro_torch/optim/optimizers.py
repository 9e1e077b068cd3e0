"""Optimizers as functional (init, update) pairs over parameter trees:
port of ``src/repro/optim/optimizers.py``.

  opt = adamw(3e-4, weight_decay=0.1)
  state = opt.init(params)
  updates, state = opt.update(grads, state, params)
  params = apply_updates(params, updates)

Learning rates may be floats or schedules (callables step → lr); the
step counter, a 0-d int32 tensor on the parameters' device, lives inside
the optimizer state.  Moments are float32 whatever the parameters'
dtype, and every update is computed in the JAX package's float32
operations and order.  Not ``torch.optim``: its AdamW decays the weights
as ``p·(1 − lr·wd)`` before the step, another order of operations.
Nothing is updated in place: each call returns new moment and update
tensors, and only those fresh tensors are written in place while they
are formed, so no more than one leaf's temporary is alive at a time.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.utils.trees import tree_leaves, tree_map

f32 = torch.float32
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def _lr_at(lr: Schedule, step):
    return lr(step) if callable(lr) else lr


def _step0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _f32_zeros(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the
    norm before scaling)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                        for g in tree_leaves(grads)))
    # a true division: ``float / tensor`` multiplies by a reciprocal
    scale = torch.clamp(torch.full_like(gn, max_norm)
                        / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


# ----------------------------------------------------------------- SGD

def sgd(lr: Schedule, momentum: float = 0.0, nesterov: bool = False
        ) -> Optimizer:
    def init(params):
        return {"step": _step0(params),
                "mu": _f32_zeros(params) if momentum else None}

    def update(grads, state, params=None):
        step = state["step"] + 1
        neg_lr = -_lr_at(lr, step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(f32),
                          state["mu"], grads)
            g_eff = (tree_map(lambda m, g: momentum * m + g.to(f32), mu,
                              grads) if nesterov else mu)
            upd = tree_map(lambda g: neg_lr * g, g_eff)
            return upd, {"step": step, "mu": mu}
        upd = tree_map(lambda g: neg_lr * g.to(f32), grads)
        return upd, {"step": step, "mu": None}

    return Optimizer(init, update)


# ----------------------------------------------------------------- Adam(W)

def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments (params may be lower precision)."""
    def init(params):
        return {"step": _step0(params), "m": _f32_zeros(params),
                "v": _f32_zeros(params)}

    def moment(old, g, beta, square):
        """beta·old + (1 − beta)·g (or g²), as the JAX package orders it."""
        g = g.to(f32)
        term = torch.square(g).mul_(1 - beta) if square else g * (1 - beta)
        return (old * beta).add_(term)

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        m = tree_map(lambda m_, g: moment(m_, g, b1, False), state["m"],
                     grads)
        v = tree_map(lambda v_, g: moment(v_, g, b2, True), state["v"],
                     grads)
        s = step.to(f32)
        bc1 = 1 - torch.pow(b1, s)
        bc2 = 1 - torch.pow(b2, s)
        neg_lr = -lr_t
        decay = lr_t * weight_decay if weight_decay else None

        def upd(m_, v_, p):
            u = (m_ / bc1).mul_(neg_lr)
            u.div_((v_ / bc2).sqrt_().add_(eps))
            if decay is not None:
                u.sub_(decay * p.to(f32))
            return u
        updates = tree_map(upd, m, v, params)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return adamw(lr, b1, b2, eps, weight_decay=0.0)
