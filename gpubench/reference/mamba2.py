"""Plain Mamba2 language model: a stack of pre-norm Mamba2 (SSD) layers,
the final norm and the LM head, tied to the embedding table or not; and
the decentralized train step around it (every node's loss and gradient,
AdamW, and the combine of the communicated leaves as the traffic mix's
``combine`` states it).

Float32 with TF32 off (``common.strict_float32``), autograd for the
gradients, each layer recomputed in the backward pass
(``torch.utils.checkpoint``) so that a node's activations fit beside the
nodes' weights and moments; the SSD in its chunked dual form, a chunk's
state carried by a loop.  The weights come in the benchmark's layout: a
flat dict of ``path → tensor``, a layer's leaves stacked (n, ...) under
``seg<i>``.
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference import common as C

f32 = torch.float32
SSD_CHUNK = 64


def ssd(x, dt, A, Bm, Cm, chunk: int = SSD_CHUNK):
    """y_t = Σ_{s≤t} C_t·B_s exp(Σ_{s<r≤t} dt_r A) dt_s x_s, by chunks:
    inside a chunk the masked quadratic form, across chunks the (P, N)
    state.  x: (B, S, H, P); dt: (B, S, H); A: (H,); Bm, Cm: (B, S, N)."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    x = x.reshape(Bb, nc, chunk, H, P)
    dt = dt.reshape(Bb, nc, chunk, H)
    Bm, Cm = Bm.reshape(Bb, nc, chunk, N), Cm.reshape(Bb, nc, chunk, N)
    cs = torch.cumsum(dt * A, dim=2)                       # (B, c, Q, H)
    idx = torch.arange(chunk, device=x.device)
    lower = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(lower, cs[:, :, :, None] - cs[:, :, None],
                                  -torch.inf))             # (B, c, Qi, Qj, H)
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)
    w = cb[..., None] * decay * dt[:, :, None]             # (B, c, Qi, Qj, H)
    y = torch.einsum("bcijh,bcjhp->bcihp", w, x)
    to_end = torch.exp(cs[:, :, -1:] - cs) * dt            # (B, c, Q, H)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn", to_end, Bm, x)
    h = torch.zeros((Bb, H, P, N), dtype=x.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = torch.exp(cs[:, c, -1])[..., None, None] * h + states[:, c]
    carried = torch.stack(entering, dim=1)                 # (B, c, H, P, N)
    y = y + torch.einsum("bcin,bchpn->bcihp", Cm, carried) \
        * torch.exp(cs)[..., None]
    return y.reshape(Bb, nc * chunk, H, P)[:, :S]


def mamba2(p, h, cfg, mm: C.Matmul):
    """in_proj → z | x B C | dt; the causal depthwise conv and SiLU over
    x B C; the SSD with the D skip; the gated RMS norm; out_proj."""
    Bb, S, d = h.shape
    di = cfg["ssm_expand"] * d
    N, P, K = cfg["ssm_state"], cfg["ssm_headdim"], cfg["ssm_conv"]
    H = di // P
    zxbcdt = mm(h, p["in_proj/w"])
    z, xbc, dt_raw = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
                      zxbcdt[..., 2 * di + 2 * N:])
    w = p["conv_w"]                                        # (K, channels)
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(padded[:, i:i + S] * w[i] for i in range(K))
    xbc = F.silu(conv + p["conv_b"])
    xs = xbc[..., :di].reshape(Bb, S, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(xs, dt, A, Bm, Cm) + xs * p["D"][:, None]
    g = y.reshape(Bb, S, di) * F.silu(z)
    g = C.rms_norm(g, p["norm/scale"], cfg["norm_eps"])
    return mm(g, p["out_proj/w"])


def segments(params: dict):
    """The stacked Mamba2 segments in order: ``seg<i>`` → its layers."""
    out = []
    for key in sorted({k.split("/")[0] for k in params
                       if re.fullmatch(r"seg\d+", k.split("/")[0])},
                      key=lambda s: int(s[3:])):
        out.append((key, params[f"{key}/norm1/scale"].shape[0]))
    return out


def logits(params: dict, tokens, cfg, mm: C.Matmul):
    """Every position's logits (B, S, V) of one node's weights."""
    eps = cfg["norm_eps"]
    x = params["embed/table"][tokens].float()

    def layer(p, j, x):
        p = {k: v[j] for k, v in p.items()}
        return x + mamba2(C.sub(p, "mixer"), C.rms_norm(
            x, p["norm1/scale"], eps), cfg, mm)

    for key, n in segments(params):
        p = C.sub(params, key)
        for j in range(n):
            x = checkpoint(layer, p, j, x, use_reentrant=False)
    x = C.rms_norm(x, params["final_norm/scale"], eps)
    if cfg.get("tie_embeddings"):
        return mm(x, params["embed/table"].T)
    return mm(x, params["lm_head/w"])


def combine(stacked, rule: dict):
    """``rule["rounds"]`` rounds of the circulant mix of ``rule["shifts"]``
    over the leading node axis (:func:`common.ring_mix`)."""
    for _ in range(rule["rounds"]):
        stacked = C.ring_mix(stacked, rule["shifts"], rule.get("self_weight"))
    return stacked


def train(params0: dict, batches, cfg, traffic, precision="float32"):
    """``len(batches)`` decentralized train steps from the replicated
    weights ``params0``: each node's loss and gradient on its shard, an
    AdamW update of each node, and the mix's ``combine`` of every leaf
    that no ``local`` pattern matches, of the gradients before the
    update (``stage`` ``grads``) or of the weights after it
    (``params``).  ``batches``: dicts of ``tokens`` and ``labels``
    (nodes, per-node batch, S).  → (losses [step][node], the first
    step's gradients {path: (nodes, ...)}, the weights after the last
    step {path: (nodes, ...)})."""
    C.strict_float32()
    mm = C.Matmul(precision)
    nodes, opt, rule = traffic["nodes"], traffic["optimizer"], \
        traffic["combine"]
    local = [re.compile(s) for s in rule["local"]]
    mixed = [k for k in params0 if not any(r.search(k) for r in local)]
    params = {k: v.float().expand(nodes, *v.shape).clone()
              for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v_ = {k: torch.zeros_like(v) for k, v in params.items()}
    first = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = []

    def update(g, grads, step):
        """Node g's AdamW step on ``grads``, the gradient as the optimizer
        gets it: the first step's is the one the check reads."""
        for k in params:
            if step == 1:
                first[k][g] = grads[k]
            params[k][g], m[k][g], v_[k][g] = C.adamw_step(
                params[k][g], grads[k], m[k][g], v_[k][g], step, opt)

    for step, batch in enumerate(batches, start=1):
        held, step_losses = [], []
        for g in range(nodes):
            leaves = {k: v[g].detach().requires_grad_() for k, v in
                      params.items()}
            with torch.enable_grad():
                loss = C.next_token_loss(
                    logits(leaves, batch["tokens"][g], cfg, mm),
                    batch["labels"][g])
                got = torch.autograd.grad(loss, list(leaves.values()),
                                          allow_unused=True)
            grads = {k: torch.zeros_like(leaves[k]) if gr is None else gr
                     for k, gr in zip(leaves, got)}
            step_losses.append(float(loss.detach()))
            del leaves, got, loss
            if rule["stage"] == "grads":
                held.append(grads)
            else:
                update(g, grads, step)
            del grads
        losses.append(step_losses)
        if rule["stage"] == "grads":
            for k in mixed:
                stacked = combine(torch.stack([h[k] for h in held]), rule)
                for g in range(nodes):
                    held[g][k] = stacked[g]
            for g in range(nodes):
                update(g, held[g], step)
            del held
        else:
            for k in mixed:
                params[k] = combine(params[k], rule)
    return losses, first, params
