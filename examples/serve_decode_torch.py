"""Batched generation across architecture families on the PyTorch/CUDA
port — attention (GQA ring-buffer KV cache), SSM (O(1) recurrent
state), the zamba hybrid and the sliding-window vlm backbone (the
port's counterpart of ``serve_decode.py``; the MTRL counterpart is
``serve_personalize_torch.py``).  Smoke variants from seeded weights.

Each prompt is served both ways the port serves a sequence: a
teacher-forced decode that fills the cache a token at a time, and one
full-sequence prefill step (on the card through the hand-written
``flash_attention`` / ``ssd_scan`` kernels); their last logits agree.
Runs on the card unless asked for the CPU:

  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate_tokens
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models.transformer import (
    LanguageModel, init_params, serving_params,
)

ARCHS = ("qwen3-1.7b",               # GQA + qk-norm
         "mamba2-130m",              # attention-free SSD
         "zamba2-7b",                # hybrid + shared attention
         "llava-next-mistral-7b")    # sliding-window ring KV


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--gen", type=int, default=6)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("batched decode across architecture families (smoke configs):\n")
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).smoke()
        model = LanguageModel(cfg, serving_params(
            init_params(cfg, seed=0, device=device), cfg))
        g = torch.Generator(device=device).manual_seed(0)
        prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=g,
                               device=device)
        tokens, stats = generate_tokens(model, prompt, args.gen,
                                        keep_prefill_logits=True)
        last = make_prefill_step(cfg)(model.params, {"tokens": prompt})
        diff = float((last - stats["prefill_logits"][:, -1]).abs().max())
        out[arch] = {"tokens": tokens[0].tolist(), "prefill_vs_decode": diff}
        print(f"{arch:<24} first row: {tokens[0].tolist()}  "
              f"({stats['tok_per_s']:.1f} tok/s/seq; prefill vs decode "
              f"max |Δlogit| {diff:.1e})")
    print("\nAll four families share one serve_step API: "
          "decode_step(params, cache, token, cfg).")
    return out


if __name__ == "__main__":
    main()
