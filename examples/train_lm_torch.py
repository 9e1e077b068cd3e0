"""End-to-end LM training on the PyTorch/CUDA port: a few hundred steps
with the paper's diffusion aggregation, the loss falling (the synthetic
Markov stream has ~ln 17 ≈ 2.8 nats of irreducible entropy, so the
learning shows), then a checkpoint save and restore, bit for bit (the
port's counterpart of ``train_lm.py``).

The default model is small (~15M parameters); ``--hundred-m`` takes the
~100M-parameter variant.  Runs on the card unless asked for the CPU:

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.distributed import AggregationConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models import count_params, init_params
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.utils.trees import tree_leaves


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--aggregation", default="diffusion")
    ap.add_argument("--hundred-m", action="store_true",
                    help="the ~100M-parameter variant")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.hundred_m:
        size = dict(n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
                    d_head=64, d_ff=3072, vocab_size=32768)
    else:       # ~15M parameters
        size = dict(n_layers=4, d_model=320, n_heads=4, n_kv_heads=2,
                    d_head=80, d_ff=1024, vocab_size=4096)
    cfg = dataclasses.replace(
        get_config("qwen3-1.7b"), name="qwen3-mini", remat=False,
        dtype="float32", **size)
    params = init_params(cfg, seed=0, device=device)
    print(f"model: {cfg.name}  ({count_params(params) / 1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}) on {device.type}")

    n_nodes, per_node, seq = args.nodes, 4, 128
    params = steps_lib.replicate_for_nodes(params, n_nodes)
    opt = adamw(warmup_cosine(3e-3, 30, args.steps), weight_decay=0.01)
    state = steps_lib.TrainState(
        params, opt.init(params),
        torch.zeros((), dtype=torch.int32, device=device))
    agg = AggregationConfig(strategy=args.aggregation, t_con=1,
                            local_patterns=("embed", "lm_head"))
    step_fn = steps_lib.make_train_step_fused(cfg, opt, agg, n_nodes)
    ds = SyntheticLM(cfg.vocab_size, seq, n_nodes * per_node, seed=0)
    # a fixed pool of 10 batches (epochs over a small dataset, so the
    # learning shows within a few hundred steps)
    pool = [ds.batch(i)["tokens"].reshape(n_nodes, per_node, seq).to(device)
            for i in range(10)]

    t0, first = time.time(), None
    for i in range(args.steps):
        toks = pool[i % len(pool)]
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        first = first if first is not None else loss
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"({time.time() - t0:.1f}s)")
    assert loss < first, "loss did not decrease"
    print(f"\nloss {first:.4f} → {loss:.4f} over {args.steps} steps "
          f"({args.aggregation} aggregation, {n_nodes} nodes)")

    # checkpoint round trip
    with tempfile.TemporaryDirectory() as path:
        save_checkpoint(path, args.steps, state.params)
        restored = restore_checkpoint(path, args.steps, state.params)
        equal = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state.params), tree_leaves(restored), strict=True))
    assert equal, "checkpoint round trip changed a leaf"
    print("checkpoint round-trip OK (bit for bit)")
    return {"loss0": first, "loss": loss, "roundtrip_equal": equal}


if __name__ == "__main__":
    main()
