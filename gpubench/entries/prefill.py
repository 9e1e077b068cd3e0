"""Entry ``prefill``: ``make_prefill_step`` on the serving copy
(``serving_params``), a unit one call of ``batch`` prompts of ``seq``
tokens, its answers each prompt's last-position logits.

The driver keeps only the answers the check will read: ``check_rows`` of
them (the cell's file), drawn from the seed as they come by reservoir
sampling over every (call, row) of the run, so what it holds stays the
same however long the window is.

Faults:  ``stale_answer`` (a call answers with the previous call's
logits), ``half_batch`` (the second half of the rows answered with the
first half's), ``altered_answer`` (in every answer one token's logit
raised past the best).
"""
from __future__ import annotations

import random

import torch

from gpubench import check, drivers, roofline as rf, weights as W

NUMBERS = ("greedy_gap", "logit_rel_l2", "top_logit_err")
FAULTS = ("stale_answer", "half_batch", "altered_answer")


def shape(traffic: dict) -> tuple:
    return (traffic["batch"], traffic["seq"])


def tokens(traffic: dict) -> int:
    return traffic["batch"] * traffic["seq"]


def prompts(traffic: dict) -> int:
    """Requests a unit answers: a call's prompts."""
    return traffic["batch"]


def rows(traffic: dict) -> int:
    """Sequences one kernel call sees: the call's prompts."""
    return traffic["batch"]


def inputs(tokens) -> dict:
    return {"tokens": tokens}


def flops(model: dict, traffic: dict) -> int:
    return rf.prefill_flops(model, traffic["batch"], traffic["seq"])


class Sample:
    """``n`` answers drawn uniformly from all that ``add`` is given, from
    ``seed`` (reservoir sampling): [(tokens (S,), logits (V,))]."""

    def __init__(self, n: int, seed: int):
        self.n, self.seen, self.rows = n, 0, []
        self.rng = random.Random(int(seed))

    def add(self, tokens, logits) -> None:
        for r in range(tokens.shape[0]):
            if len(self.rows) < self.n:
                self.rows.append((tokens[r].clone(), logits[r].clone()))
            else:
                j = self.rng.randrange(self.seen + 1)
                if j < self.n:
                    self.rows[j] = (tokens[r].clone(), logits[r].clone())
            self.seen += 1


class Driver(drivers.Driver):
    def setup(self) -> None:
        from repro_torch.launch import steps
        from repro_torch.models import transformer as tfm
        self.build()
        flat = W.make(self.shapes, self.config["init"], self.seed,
                      self.device, serve=True)
        self.params = tfm.serving_params(W.nest(flat), self.cfg)
        self.prefill = steps.make_prefill_step(self.cfg)
        for _ in range(self.traffic.get("warm_units", 1)):
            self.answer(self.prepare())
        drivers.sync(self.device)
        self.sample = Sample(self.cellfile["check_rows"], self.seed)

    def answer(self, batch):
        return self.prefill(self.params, batch)

    def call(self, batch):
        """One prefill call; → its last-position logits (B, V), a sample of
        them kept for the check (waits for the card)."""
        logits = self.answer(batch)
        drivers.sync(self.device)
        self.sample.add(batch["tokens"], logits)
        return logits

    def finish(self) -> list:
        del self.params, self.prefill
        return self.sample.rows


def faults(traffic: dict) -> list:
    """The faults a cell of this mix can have: half of a batch of one is
    no fault."""
    return [f for f in FAULTS if f != "half_batch" or traffic["batch"] > 1]


def plant(driver: Driver, fault: str) -> None:
    """Break ``driver``'s answers before its set-up."""
    if fault not in faults(driver.traffic):
        raise ValueError(f"no fault {fault!r} for this prefill mix")
    answer, previous = driver.answer, []

    def faulty(batch):
        logits = answer(batch)
        if fault == "stale_answer":
            wrong = previous[-1] if previous else torch.zeros_like(logits)
            previous[:] = [logits]
            return wrong
        if fault == "half_batch":
            n = logits.shape[0] // 2
            return torch.cat([logits[:n], logits[:logits.shape[0] - n]])
        logits = logits.clone()
        logits[:, 1] = logits.max(dim=1).values + 1.0
        return logits
    driver.answer = faulty


def check_numbers(got, config, traffic, cellfile, shapes, seed,
                  device) -> dict:
    """The kept answers against the float32 reference's."""
    return check.compare_prefill(config, got, shapes, seed, device)


def control(config, traffic, cellfile, shapes, seed, device) -> dict:
    """The reference with FP8 products in the program's place, over as
    many prompts of the feed as a run checks."""
    from gpubench import generator
    feed = generator.Feed(traffic, config["model"]["vocab_size"], seed,
                          device)
    n, prompts_ = cellfile["check_rows"], []
    while len(prompts_) < n:
        prompts_ += list(feed.next()["tokens"])
    return check.compare_prefill(config, [(t, None) for t in prompts_[:n]],
                                 shapes, seed, device, precision="fp8")
