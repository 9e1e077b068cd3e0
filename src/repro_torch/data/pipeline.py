"""Data pipelines: port of ``src/repro/data/pipeline.py``.

Two kinds of data feed the framework:

  * token streams for the architecture zoo — a deterministic synthetic
    LM stream (uniform start, Markov structure, so losses actually
    decrease during the example runs), sharded per node;
  * the paper's MTRL task data — (X_t, y_t) regression pairs
    partitioned over nodes (:mod:`repro_torch.core.problem` generates
    them; :func:`node_task_loader` is the view one node reads).

The draws come from CPU ``torch.Generator``s seeded as the JAX package
seeds its keys, one per (seed, step, node): torch cannot replay
``jax.random``, so the port's tokens are its own (cross-package tests
pass the JAX package's tokens across as numpy).  Tokens are int64
(torch's index dtype; the JAX package's are int32) on the CPU; the
trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.frontends import vlm_batch_stub

def fold_generator(*keys: int) -> torch.Generator:
    """A CPU generator seeded from the integers ``keys``: distinct tuples
    give independent streams (numpy's SeedSequence mixes them), as
    ``jax.random.fold_in`` of a key by each integer does."""
    seed = np.random.SeedSequence([int(k) for k in keys]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic language-model stream.

    Tokens follow a first-order Markov chain over ``vocab_size`` states:
    t_{i+1} = (7·t_i + ε_i + 3) mod V with ε uniform on [0, 17) and t_0
    uniform on [0, V), position 0 holding t_1.  Every (seed, step, node)
    triple maps to its own generator, so multi-node loaders never overlap
    and runs replay exactly.
    """
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def batch(self, step: int, node: int = 0, n_nodes: int = 1):
        """{"tokens": (batch_size, seq_len) int64} of ``step`` for
        ``node`` (``n_nodes`` is the reference's signature; the stream
        depends on the node alone)."""
        g = fold_generator(self.seed, step, node)
        V = self.vocab_size
        cur = torch.randint(0, V, (self.batch_size,), generator=g)
        noise = torch.randint(0, 17, (self.batch_size, self.seq_len),
                              generator=g)
        toks = torch.empty((self.batch_size, self.seq_len),
                           dtype=torch.int64)
        for i in range(self.seq_len):
            cur = (7 * cur + noise[:, i] + 3) % V
            toks[:, i] = cur
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_lm_batch(generator: torch.Generator, cfg, batch: int, seq: int):
    """One random batch matching cfg's modality (labels = shifted
    tokens), drawn from ``generator``: a vlm's is ``vis_tokens`` patch
    embeddings and ``seq − vis_tokens`` text tokens."""
    if cfg.modality == "vlm":
        b = vlm_batch_stub(generator, batch, seq, cfg)
    else:
        b = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                     generator=generator)}
    b["labels"] = torch.roll(b["tokens"], -1, dims=1)
    return b


def make_batch_for(cfg, batch: int, seq: int, seed: int = 0):
    return make_lm_batch(fold_generator(seed), cfg, batch, seq)


def node_task_loader(problem, node: int):
    """Per-node view of an MTRL problem: the node's (X_t, y_t) task
    shard — the only data node g ever sees (federated constraint)."""
    tasks = problem.tasks_per_node[node]
    idx = torch.as_tensor(tasks, device=problem.X.device)
    X = problem.X.index_select(-3, idx)
    y = problem.y.index_select(-2, idx)
    return {"tasks": tasks, "X": X, "y": y}
