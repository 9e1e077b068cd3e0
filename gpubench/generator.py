"""The one traffic generator: a traffic mix's data file in, the inputs of
each unit of work out, drawn from the seed on the device.

A mix names its ``entry`` (a module of :mod:`gpubench.entries`, found by
that name), which gives the sizes of a unit (``entry.shape(traffic)``)
and what a unit's inputs hold beside its tokens (``entry.inputs``).  Its
``loop`` is ``closed``: a unit is sent when the last has ended.  Tokens
are ``uniform`` over the vocabulary.  Every unit has the same sizes
whatever the seed, and unit i's tokens are the i-th draw of the feed's
generator, so a seed gives the same inputs on every run and to either
side.
"""
from __future__ import annotations

import importlib

import torch


def entry(name: str):
    """The entry module ``gpubench/entries/<name>.py``."""
    return importlib.import_module(f"gpubench.entries.{name}")


def feed_seed(seed: int) -> int:
    """The feed's generator seed, apart from the weights' (``seed``)."""
    return (2 * int(seed) + 1) % 2 ** 63


class Feed:
    """Unit after unit of ``traffic``'s inputs for a vocabulary of
    ``vocab`` tokens, from ``seed``, on ``device``."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        if traffic.get("tokens", "uniform") != "uniform":
            raise ValueError(f"unknown token draw {traffic['tokens']!r}")
        if traffic.get("loop", "closed") != "closed":
            raise ValueError(f"unknown loop {traffic['loop']!r}: each unit "
                             f"is sent when the last has ended")
        self.traffic, self.vocab, self.device = traffic, vocab, device
        self.entry = entry(traffic["entry"])
        self.shape = self.entry.shape(traffic)
        self.gen = torch.Generator(device=device).manual_seed(
            feed_seed(seed))

    def next(self) -> dict:
        tokens = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                               device=self.device)
        return self.entry.inputs(tokens)
