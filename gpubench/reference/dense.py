"""Plain dense decoder: pre-norm blocks of grouped-query attention
(RoPE, causal) and SwiGLU, the final norm and the LM head, tied to the
embedding table or not; the logits at the last position of one prompt.

Float32 with TF32 off (``common.strict_float32``), computed a layer at
a time and the attention a block of queries at a time, so a 32k-token
prompt fits beside nothing else.  The weights come in the benchmark's
layout: a flat dict of ``path → tensor``, each block's leaves stacked
(n_layers, ...) under ``seg0``; they are read in their stored dtype and
widened to float32 a layer at a time.
"""
from __future__ import annotations

import torch

from gpubench.reference import common as C


@torch.no_grad()
def last_logits(params: dict, tokens, cfg, precision: str = "float32"):
    """tokens (S,) → the logits at the last position (V,), float32."""
    C.strict_float32()
    mm = C.Matmul(precision)
    eps = cfg["norm_eps"]
    x = params["embed/table"][tokens][None].float()
    seg = C.sub(params, "seg0")
    for i in range(cfg["n_layers"]):
        p = {k: v[i].float() for k, v in seg.items()}
        h = C.rms_norm(x, p["norm1/scale"], eps)
        x = x + C.gqa(C.sub(p, "mixer"), h, cfg, mm)
        h = C.rms_norm(x, p["norm2/scale"], eps)
        x = x + C.swiglu(C.sub(p, "ffn"), h, mm)
        del p, h
    x = C.rms_norm(x[:, -1], params["final_norm/scale"].float(), eps)
    if cfg.get("tie_embeddings"):
        head = params["embed/table"].float().T
    else:
        head = params["lm_head/w"].float()
    return mm(x, head)[0]
