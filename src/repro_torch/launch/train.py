"""Training launcher: decentralized-diffusion LM training of node-stacked
replicas on one device.  Port of ``src/repro/launch/train.py``.  Runs on
the card unless asked for the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --steps 50 --aggregation diffusion --nodes 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --full --steps 20 --seq 1024

On the card the forward runs the hand-written ``flash_attention``
(attention models) and ``ssd_scan`` (Mamba2) kernels, and each gossip
round of a communicated leaf one ``gossip_combine`` launch.  ``--layers``
cuts the depth of a configuration that does not fit the card whole.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM, fold_generator
from repro_torch.distributed.aggregation import AggregationConfig
from repro_torch.launch import steps as steps_lib
from repro_torch.models.frontends import vlm_batch_stub
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.train")


def make_batch(cfg, generator, n_nodes, per_node, seq):
    """Uniform random tokens (n_nodes, per_node, seq) from ``generator``
    — a vlm's ``vis_tokens`` patch embeddings (n_nodes, per_node,
    vis_tokens, d) and ``seq − vis_tokens`` text tokens — labels the
    tokens shifted by one."""
    if cfg.modality == "vlm":
        b = vlm_batch_stub(generator, n_nodes * per_node, seq, cfg)
        b = {k: v.reshape(n_nodes, per_node, *v.shape[1:])
             for k, v in b.items()}
    else:
        b = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (n_nodes, per_node, seq),
                                     generator=generator)}
    b["labels"] = torch.roll(b["tokens"], -1, dims=-1)
    return b


LOCAL_PATTERNS = ("embed", "lm_head")      # node-local, never communicated


def make_trainer(cfg, *, steps: int, n_nodes: int = 4,
                 per_node_batch: int = 2, seq: int = 64,
                 aggregation: str = "diffusion", t_con: int = 1,
                 lr: float = 3e-4, seed: int = 0,
                 use_markov_data: bool = True, device=None):
    """What :func:`train` runs, for ``cfg``: (the initial TrainState,
    the fused step function, ``batch(i)`` → step i's batch on the
    device).  Weights from ``seed``, replicated on every node; AdamW on
    a warmup-cosine schedule over ``steps``; the embedding and LM head
    node-local."""
    device = resolve_device(device)
    params = steps_lib.replicate_for_nodes(
        init_params(cfg, seed=seed, device=device), n_nodes)
    opt = adamw(warmup_cosine(lr, max(steps // 10, 1), steps),
                weight_decay=0.1)
    state = steps_lib.TrainState(
        params, opt.init(params),
        torch.zeros((), dtype=torch.int32, device=device))
    agg = AggregationConfig(strategy=aggregation, t_con=t_con,
                            local_patterns=LOCAL_PATTERNS)
    step_fn = steps_lib.make_train_step_fused(cfg, opt, agg, n_nodes)
    ds = SyntheticLM(cfg.vocab_size, seq, n_nodes * per_node_batch,
                     seed=seed)

    def batch(i: int):
        if use_markov_data and cfg.modality != "vlm":
            toks = ds.batch(i)["tokens"].reshape(n_nodes, per_node_batch,
                                                 seq)
            b = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
        else:
            b = make_batch(cfg, fold_generator(seed, i), n_nodes,
                           per_node_batch, seq)
        return {k: v.to(device) for k, v in b.items()}
    return state, step_fn, batch


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          n_nodes: int = 4, per_node_batch: int = 2, seq: int = 64,
          aggregation: str = "diffusion", t_con: int = 1,
          lr: float = 3e-4, seed: int = 0, ckpt_dir: str | None = None,
          use_markov_data: bool = True, log_every: int = 10,
          n_layers: int | None = None, device=None):
    """``steps`` fused train steps of ``n_nodes`` replicas of ``arch``
    (its smoke variant unless ``smoke`` is False; ``n_layers`` cuts the
    depth) as :func:`make_trainer` sets them up, on ``device``, the card
    unless asked otherwise.  Returns (final TrainState, the mean loss of
    every step)."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    state, step_fn, batch = make_trainer(
        cfg, steps=steps, n_nodes=n_nodes, per_node_batch=per_node_batch,
        seq=seq, aggregation=aggregation, t_con=t_con, lr=lr, seed=seed,
        use_markov_data=use_markov_data, device=device)
    history = []
    t0 = time.time()
    for i in range(steps):
        state, metrics = step_fn(state, batch(i))
        loss = float(metrics["loss"])
        history.append(loss)
        if i % log_every == 0 or i == steps - 1:
            log.info("step %4d loss %.4f (%.2f s)", i, loss,
                     time.time() - t0)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, state.params)
        log.info("saved checkpoint to %s", ckpt_dir)
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--per-node-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--aggregation", default="diffusion")
    ap.add_argument("--t-con", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    _, history = train(args.arch, smoke=args.smoke, steps=args.steps,
                       n_nodes=args.nodes,
                       per_node_batch=args.per_node_batch, seq=args.seq,
                       aggregation=args.aggregation, t_con=args.t_con,
                       lr=args.lr, ckpt_dir=args.ckpt_dir,
                       n_layers=args.layers, device=args.device)
    print(f"final loss: {history[-1]:.4f} (from {history[0]:.4f})")


if __name__ == "__main__":
    main()
