"""Entry ``train``: ``make_train_step_fused`` as ``launch.train.make_trainer``
wires it, a unit one train step over every node's shard.

A mix gives ``nodes`` × ``per_node_batch`` × ``seq`` tokens a step (the
labels are the tokens shifted by one, the last wrapping, as the port's
trainer makes them), its ``optimizer`` (AdamW on a warm-up cosine),
``aggregation`` (the port's ``AggregationConfig`` as the program is told
it) and ``combine`` (what that means, as the reference does it: after
``stage`` ``params`` or ``grads``, ``rounds`` rounds of the circulant mix
of ``shifts`` with ``self_weight``, none where ``rounds`` is 0, over
every leaf that no ``local`` pattern matches), and ``checked_steps``,
the steps of set-up that the check compares.

Faults:  ``state_unchanged`` (the step hands back the state it got),
``half_batch`` (every node's step sees the first half of its rows, its
loss the mean over them), ``no_exchange`` (the combine between the nodes
left out), ``altered_answer`` (node 0's loss, where the step produces
it, 1 % off).
"""
from __future__ import annotations

import math

import torch

from gpubench import check, drivers, roofline as rf, weights as W

NUMBERS = ("loss_gap", "grad_norm_gap", "change_norm_gap")
FAULTS = ("state_unchanged", "half_batch", "no_exchange", "altered_answer")


def shape(traffic: dict) -> tuple:
    return (traffic["nodes"], traffic["per_node_batch"], traffic["seq"])


def tokens(traffic: dict) -> int:
    return math.prod(shape(traffic))


def prompts(traffic: dict) -> int:
    """Requests a unit answers: a train step is one."""
    return 1


def rows(traffic: dict) -> int:
    """Sequences one kernel call sees: a node's batch."""
    return traffic["per_node_batch"]


def inputs(tokens) -> dict:
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=-1)}


def flops(model: dict, traffic: dict) -> int:
    return rf.train_step_flops(model, traffic["nodes"]
                               * traffic["per_node_batch"], traffic["seq"])


class Driver(drivers.Driver):
    """Node-stacked replicas of the weights, the mix's optimizer and
    aggregation, the embedding and head as the mix keeps them."""

    def kernels(self) -> tuple:
        gossip = self.traffic["aggregation"]["strategy"] not in (
            "local", "allreduce")
        return super().kernels() + (("gossip_axpy",) if gossip else ())

    def setup(self) -> None:
        from repro_torch.distributed.aggregation import AggregationConfig
        from repro_torch.launch import steps
        from repro_torch.optim import adamw, warmup_cosine
        t, o = self.traffic, self.traffic["optimizer"]
        self.build()
        self.opt = adamw(warmup_cosine(o["lr"], o["warmup_steps"],
                                       o["total_steps"]),
                         b1=o["b1"], b2=o["b2"], eps=o["eps"],
                         weight_decay=o["weight_decay"])
        agg = AggregationConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in t["aggregation"].items()})
        self.step_fn = steps.make_train_step_fused(self.cfg, self.opt, agg,
                                                   t["nodes"])
        params0 = W.make(self.shapes, self.config["init"], self.seed,
                         self.device)
        params = steps.replicate_for_nodes(W.nest(params0), t["nodes"])
        self.state = steps.TrainState(
            params, self.opt.init(params),
            torch.zeros((), dtype=torch.int32, device=self.device))
        # the checked steps: the program's readings, and the warm-up
        losses, grads = [], None
        for k in range(t["checked_steps"]):
            losses.append(self.call(self.prepare()))
            if k == 0:
                grads = check.slice_norms(
                    W.flatten(self.state.opt_state["m"]), 1.0 / (1.0 - o["b1"]))
        self.readings = {"losses": losses, "grad_norms": grads,
                         "change_norms": check.slice_norms(
                             W.flatten(self.state.params), minus=params0)}
        del params0, params

    def call(self, batch):
        """One train step; → every node's loss (waits for the card)."""
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics["loss_per_node"].tolist()

    def finish(self) -> dict:
        del self.state, self.step_fn
        return self.readings


def faults(traffic: dict) -> list:
    """The faults a cell of this mix can have: where nothing is
    exchanged, leaving the exchange out is no fault."""
    return [f for f in FAULTS
            if f != "no_exchange" or traffic["combine"]["rounds"] > 0]


def plant(driver: Driver, fault: str) -> None:
    """Break ``driver``'s call into the program before its set-up, so the
    checked steps and the window both go through the fault."""
    if fault not in faults(driver.traffic):
        raise ValueError(f"no fault {fault!r} for this train mix")
    call, prepare = driver.call, driver.prepare
    if fault == "state_unchanged":
        def faulty(batch):
            state = driver.state
            out = call(batch)
            driver.state = state
            return out
        driver.call = faulty
    elif fault == "half_batch":
        def half():
            batch = prepare()
            n = batch["tokens"].shape[1] // 2
            return {k: v[:, :n] for k, v in batch.items()}
        driver.prepare = half
    elif fault == "no_exchange":
        t = driver.traffic
        driver.traffic = dict(t, aggregation=dict(t["aggregation"],
                                                  strategy="local"))
    else:
        def faulty(batch):
            out = call(batch)
            out[0] *= 1.01
            return out
        driver.call = faulty


def check_numbers(got, config, traffic, cellfile, shapes, seed,
                  device) -> dict:
    """The program's readings against the float32 reference's."""
    return check.compare_train(got, check.reference_train(
        config, traffic, shapes, seed, device))


def control(config, traffic, cellfile, shapes, seed, device) -> dict:
    """The reference with FP8 products in the program's place."""
    want = check.reference_train(config, traffic, shapes, seed, device)
    return check.compare_train(check.reference_train(
        config, traffic, shapes, seed, device, precision="fp8"), want)
