"""What every entry's driver shares.  An entry's ``Driver``
(``gpubench/entries/<entry>.py``) is built from a configuration file's
``model`` and ``init``, a traffic mix and the cell's file.

A driver's ``setup()`` makes the weights from the seed, builds the
program's object once and warms every shape the mix uses; ``prepare()``
draws the next unit's inputs; ``call(inputs)`` runs one unit through the
program and waits for the card; ``finish()`` frees the program's state
and returns what the check compares.  Only the drivers import the
program.
"""
from __future__ import annotations

import torch

from gpubench import generator, weights as W


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, config: dict, traffic: dict, cellfile: dict,
                 seed: int, device):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import transformer as tfm
        self.config, self.traffic, self.cellfile = config, traffic, cellfile
        self.seed, self.device = int(seed), torch.device(device)
        self.model = config["model"]
        self.cfg = ModelConfig(**self.model)
        self.shapes = {p: tuple(t.shape) for p, t in W.flatten(
            tfm.init_params(self.cfg, device="meta")).items()}
        self.feed = generator.Feed(traffic, self.model["vocab_size"],
                                   self.seed, self.device)

    def kernels(self) -> tuple:
        """The port's CUDA libraries this cell runs."""
        names = []
        if self.model.get("n_heads"):
            names.append("flash_attention")
        if self.model.get("block_pattern") == "ssm":
            names.append("ssd_scan")
        return tuple(names)

    def build(self) -> None:
        """Build (first run in a checkout) and load the cell's kernels."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build(self.kernels())

    def prepare(self) -> dict:
        return self.feed.next()
