"""Modality frontends — stubs, as in the JAX package.

Port of ``src/repro/models/frontends.py``.  The [audio] and [vlm]
architectures specify the transformer backbone only; the codec / vision
tower is not implemented.  These helpers produce the tensors a real
frontend would emit, with the right shapes and dtypes:

  * musicgen: EnCodec's output is a token stream over a 2048-entry
    codebook, so its stub is a synthetic token generator;
  * llava-next: the vision tower + projector emit per-patch embeddings
    of width d_model; anyres tiling is approximated by a fixed patch
    budget ``cfg.vis_tokens`` per sample.

The draws come from an explicit ``torch.Generator`` (on the CPU unless
the generator lives elsewhere): torch cannot replay ``jax.random``, so
cross-package tests carry the JAX package's arrays across as numpy.
Token ids are int64 (torch's index dtype; the JAX package's are int32).
"""
from __future__ import annotations

import torch


def _device(generator):
    return generator.device if generator is not None else None


def audio_token_stub(generator, batch, seq_len, cfg):
    """Synthetic EnCodec token ids (B, S) in [0, vocab)."""
    return torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         generator=generator, device=_device(generator))


def vision_embed_stub(generator, batch, cfg, dtype=None):
    """Synthetic pre-projected patch embeddings (B, vis_tokens, d_model)
    ~ N(0, 0.02²) in ``dtype`` (default ``cfg.dtype``) — what the stubbed
    vision tower + projector would output."""
    dtype = getattr(torch, dtype or cfg.dtype)
    return (torch.randn((batch, cfg.vis_tokens, cfg.d_model),
                        generator=generator, device=_device(generator))
            * 0.02).to(dtype)


def vlm_batch_stub(generator, batch, seq_len, cfg):
    """Full VLM input batch: ``vis_tokens`` patch embeddings + text tokens
    such that the combined sequence length equals ``seq_len``."""
    if cfg.vis_tokens >= seq_len:
        raise ValueError(f"vis_tokens={cfg.vis_tokens} must be < seq_len")
    s_text = seq_len - cfg.vis_tokens
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, s_text),
                                    generator=generator,
                                    device=_device(generator)),
            "vis_embed": vision_embed_stub(generator, batch, cfg)}
