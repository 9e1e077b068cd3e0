"""Step functions of the server: the serving half of
``src/repro/launch/steps.py``.

Serving layout: ONE parameter copy (no node axis) — prefill is a
full-sequence forward; decode is one token against a KV/SSM cache.  The
training half (``make_train_step*``, the optimizers and the aggregation
strategies) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm


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
