"""Serving launcher: batched prefill + decode loop with the KV/SSM cache.

Port of ``src/repro/launch/serve.py``.  Runs on the card unless asked
for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --smoke --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --full
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.transformer import (
    LanguageModel, init_params, serving_params,
)
from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.serve")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate_tokens(model: LanguageModel, prompt, gen: int, *,
                    capacity: int | None = None, temperature: float = 0.0,
                    generator=None, keep_prefill_logits: bool = False):
    """Prefill ``model`` with ``prompt`` (B, S) by teacher-forced decode
    steps (the cache fill), then sample ``gen`` tokens greedily
    (temperature 0) or with Gumbel noise drawn from ``generator``.
    Returns (tokens (B, gen), stats); with ``keep_prefill_logits`` the
    stats hold the decode logits at every prompt position,
    ``"prefill_logits"`` (B, S, V)."""
    cfg, device = model.cfg, model.device
    batch, prompt_len = prompt.shape
    cap = capacity or (prompt_len + gen)
    if cfg.sliding_window:
        cap = min(cap, cfg.sliding_window)
    state = model.init_cache(batch, cap)
    kept = []
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        for i in range(prompt_len):                     # cache fill
            logits, state = model.decode_step(state, prompt[:, i:i + 1])
            if keep_prefill_logits:
                kept.append(logits[:, 0])
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out = []
        t1 = time.perf_counter()
        for _ in range(gen):
            if temperature > 0:
                u = torch.rand(logits.shape, generator=generator,
                               device=device).clamp_(min=1e-20)
                tok = torch.argmax(logits / temperature
                                   - torch.log(-torch.log(u)), dim=-1)
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok[:, 0])
            logits, state = model.decode_step(state, tok)
        _sync(device)
        t_decode = time.perf_counter() - t1
    tokens = torch.stack(out, dim=1)
    log.info("prefill %d tok in %.2fs; decode %d tok in %.2fs "
             "(%.1f tok/s/seq)", prompt_len, t_prefill, gen, t_decode,
             gen / max(t_decode, 1e-9))
    stats = dict(prefill_s=t_prefill, decode_s=t_decode,
                 tok_per_s=gen / max(t_decode, 1e-9))
    if keep_prefill_logits:
        stats["prefill_logits"] = torch.stack(kept, dim=1)
    return tokens, stats


def generate(arch: str, *, smoke: bool = True, batch: int = 2,
             prompt_len: int = 16, gen: int = 8, capacity: int | None = None,
             temperature: float = 0.0, seed: int = 0, device=None):
    """Random weights for ``arch`` (its smoke variant unless ``smoke`` is
    False) drawn from ``seed`` on ``device`` (the card unless asked
    otherwise; raises RuntimeError without one), their linear weights
    cast once to the activation dtype; a random prompt and the Gumbel
    noise from a generator seeded with ``seed``; then
    :func:`generate_tokens`."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    device = resolve_device(device)
    model = LanguageModel(cfg, serving_params(
        init_params(cfg, seed=seed, device=device), cfg))
    g = torch.Generator(device=device).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=g, device=device)
    return generate_tokens(model, prompt, gen, capacity=capacity,
                           temperature=temperature, generator=g)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    tokens, stats = generate(args.arch, smoke=args.smoke, batch=args.batch,
                             prompt_len=args.prompt_len, gen=args.gen,
                             temperature=args.temperature, device=args.device)
    print("generated token ids (first row):", tokens[0].tolist())
    print(stats)


if __name__ == "__main__":
    main()
