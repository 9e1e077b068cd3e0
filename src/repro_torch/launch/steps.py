"""Step functions of the distributed trainer and of the server: port of
``src/repro/launch/steps.py``.

Training layout (the paper's decentralized setting on one device): every
param/optimizer leaf carries a leading **node axis** of size n_nodes.
Node g's replica trains on node g's batch shard; communication between
replicas is the pluggable aggregation strategy (diffusion = the paper's
Dif-AltGDmin pattern; allreduce = the fusion-center baseline; consensus
= Dec-AltGDmin; dgd; topk; quantized; local).  The reference vmaps the
replicas; the port runs them as a Python loop, since ``torch.func.vmap``
cannot pass through the ctypes kernels of the forward.

Serving layout: ONE parameter copy (no node axis) — prefill is a
full-sequence forward; decode is one token against a KV/SSM cache.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed.aggregation import (
    AggregationConfig, aggregate_gradients, aggregate_params,
)
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import apply_updates
from repro_torch.utils.trees import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor            # 0-d int32 on the parameters' device


def cross_entropy(logits, labels):
    """Mean next-token NLL. logits: (B,S,V) f32; labels: (B,S_l) aligned
    to the LAST S_l positions."""
    S_l = labels.shape[1]
    ls = torch.log_softmax(logits[:, -S_l:], dim=-1)
    nll = -torch.gather(ls, -1, labels[..., None].long())
    return torch.mean(nll)


def loss_fn(params, batch, cfg):
    logits, aux = tfm.forward(params, batch, cfg)
    return cross_entropy(logits, batch["labels"]) + aux


# ----------------------------------------------------------------- train

def replicate_for_nodes(tree, n_nodes: int):
    """Stack n_nodes copies along a new leading axis (dim 0)."""
    return tree_map(
        lambda x: x.detach().expand(n_nodes, *x.shape).contiguous(), tree)


def _node_slices(tree, g: int, fn, plan):
    """``fn`` on node g's slice of every leaf of a node-stacked parameter
    tree whose segments follow ``plan``, each segment's stacked layers
    split into a list of one tree a layer — a zamba segment's into a
    list of groups, each a list of layers (the form
    ``transformer._index`` reads as it is)."""
    def split(sub, axes, idx):
        if not axes:
            return tree_map(lambda x: fn(x[(g, *idx)]), sub)
        return [split(sub, axes[1:], (*idx, j)) for j in range(axes[0])]

    out = {}
    for key, sub in tree.items():
        seg = plan[int(key[3:])] if key.startswith("seg") else None
        out[key] = split(sub, tfm.layer_axes(seg) if seg else (), ())
    return out


def _check_nodes(params, batch, n_nodes: int):
    lead = {x.shape[0] for x in tree_leaves(params)}
    lead |= {x.shape[0] for x in batch.values()}
    if lead != {n_nodes}:
        raise ValueError(f"every parameter and batch leaf needs a leading "
                         f"node axis of {n_nodes}; got {sorted(lead)}")


def node_loss_and_grad(params, batch, cfg, g: int, grads, plan=None):
    """Node g's loss on its batch shard (detached), its gradient written
    into slot g of ``grads`` (a tree stacked like ``params``, allocated
    once for every node).

    The gradient is taken against node g's own slice: each leaf's slice
    g — each layer's, for a segment's stacked leaves — is a fresh
    autograd leaf, and its gradient is written into slot g (and layer j)
    of ``grads``.  Indexing a stacked leaf inside autograd would instead
    have every slice's backward write a zero-filled full-size gradient.
    A parameter the loss does not reach gets a zero gradient, as
    ``jax.grad`` gives."""
    plan = tfm.build_plan(cfg) if plan is None else plan
    p_g = _node_slices(params, g, lambda x: x.detach().requires_grad_(),
                       plan)
    dst = tree_leaves(_node_slices(grads, g, lambda x: x, plan))
    with torch.enable_grad():
        loss = loss_fn(p_g, {k: v[g] for k, v in batch.items()}, cfg)
        leaves = tree_leaves(p_g)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for d, gr in zip(dst, got, strict=True):
        if gr is None:
            d.zero_()
        else:
            d.copy_(gr)
    return loss.detach()


def node_value_and_grad(params, batch, cfg, n_nodes: int):
    """(losses (n_nodes,), grads): every node's loss on its batch shard
    and its gradient (:func:`node_loss_and_grad`), stacked like
    ``params``."""
    _check_nodes(params, batch, n_nodes)
    plan = tfm.build_plan(cfg)
    grads = tree_map(torch.empty_like, params)
    losses = [node_loss_and_grad(params, batch, cfg, g, grads, plan)
              for g in range(n_nodes)]
    return torch.stack(losses), grads


def node_loss(params, batch, cfg, g: int):
    """Node g's loss on its batch shard, no gradients."""
    with torch.no_grad():
        return loss_fn(tree_map(lambda x: x[g], params),
                       {k: v[g] for k, v in batch.items()}, cfg)


def _node_losses(params, batch, cfg, n_nodes: int):
    """Every node's loss on its batch shard, no gradients."""
    _check_nodes(params, batch, n_nodes)
    return torch.stack([node_loss(params, batch, cfg, g)
                        for g in range(n_nodes)])


def train_step_from(state: TrainState, losses_and_grads, opt,
                    agg: AggregationConfig):
    """A train step around ``losses_and_grads()`` → (losses (n_nodes,),
    grads stacked like the parameters): the gradient communication, the
    node-local optimizer update, the parameter communication →
    (TrainState, metrics).  The gradients are made here, so this frame
    holds their only reference and frees them before the new parameters
    are formed."""
    losses, grads = losses_and_grads()
    grads = aggregate_gradients(grads, agg)            # consensus/AR
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    del grads
    params = apply_updates(state.params, updates)
    del updates
    params = aggregate_params(params, agg)             # diffusion/dgd
    metrics = {"loss": torch.mean(losses), "loss_per_node": losses}
    return TrainState(params, opt_state, state.step + 1), metrics


def _train_step(cfg, opt, agg: AggregationConfig, n_nodes: int, fused):
    def losses_and_grads(params, batch):
        if fused:
            return node_value_and_grad(params, batch, cfg, n_nodes)
        losses = _node_losses(params, batch, cfg, n_nodes)
        return losses, node_value_and_grad(params, batch, cfg, n_nodes)[1]

    def step(state: TrainState, batch):
        return train_step_from(
            state, lambda: losses_and_grads(state.params, batch), opt, agg)
    return step


def make_train_step(cfg, opt, agg: AggregationConfig, n_nodes: int):
    """Returns step(state, batch) → (state, metrics).

    batch leaves: (n_nodes, per_node_batch, ...).  Losses come from a
    forward pass without gradients, then gradients per node (each node's
    against its own slice), communicated per the aggregation strategy;
    the optimizer update is node-local (elementwise over the stacked
    leaves); diffusion gossips the updated parameters."""
    return _train_step(cfg, opt, agg, n_nodes, fused=False)


def make_train_step_fused(cfg, opt, agg: AggregationConfig, n_nodes: int):
    """:func:`make_train_step` with the loss taken from the gradient's
    own forward pass (one pass computes both — the production variant,
    the one ``launch.train`` runs; kept separate so the fusion can be
    A/B'd)."""
    return _train_step(cfg, opt, agg, n_nodes, fused=True)


# ----------------------------------------------------------------- serve

def make_prefill_step(cfg):
    """Full-sequence forward; returns last-position logits (the sampler's
    input) — (B, V) f32.  Only the last position goes through the LM
    head: the JAX package computes every position's logits and slices,
    which is the same function."""
    def prefill(params, batch):
        with torch.no_grad():
            x, _ = tfm.hidden_states(params, batch, cfg)
            return tfm.logits_of(params, x[:, -1], cfg)
    return prefill


def make_serve_step(cfg):
    """ONE decode token: (params, state, tokens (B,1)) → (logits, state);
    the state's caches are updated in place."""
    def serve(params, state, tokens):
        with torch.no_grad():
            return tfm.decode_step(params, state, tokens, cfg)
    return serve
