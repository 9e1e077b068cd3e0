"""Dry run on the meta device: every (architecture × input shape × mesh)
combination's step run once on meta tensors, with its memory, operation,
traffic and collective accounting per device and its roofline against
one NVIDIA H100.  Port of ``src/repro/launch/dryrun.py``: the same
flags and record keys; nothing is allocated and no device is read, so
it runs on any host, a CPU-only one included:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out experiments/dryrun_torch

What each number is (the reference reads them from XLA's compiled
program; here they come from running the eager program on meta tensors,
which have shapes and dtypes and no data):

  * argument bytes — exact: each argument leaf's block on one device
    (:func:`repro_torch.launch.sharding.local_shape` of its spec), summed
    over parameters, optimizer state, batch and cache;
  * FLOPs — ``torch.utils.flop_counter.FlopCounterMode`` (matrix
    products, as it counts them) over the step on the ``cuda`` route,
    plus the hand-written kernels' own counts: inside
    ``_build.recording()`` the ``flash_attention``, ``ssd_scan`` and
    ``gossip_combine`` wrappers take meta tensors, return outputs of the
    kernel's shape, count the launch and hand their operands here, where
    each wrapper's ``cost`` (the counts of ``chip_smoke.py``'s bounds)
    gives the kernel's operations and bytes;
  * bytes accessed — every dispatched op's inputs plus outputs (views
    and bare allocations move nothing), plus the kernels' bytes: the
    eager program's traffic, which reads again what a fused program
    would keep;
  * peak and temp — the live bytes of meta storages, each counted from
    the op that makes it until a weakref finalizer sees it freed; the
    arguments live throughout (``fits_device``: the peak a device within
    one H100's 80 GB); the scratch ``ssd_scan``'s launch allocates (its
    f32 copies of dt, A, D and the bf16 passes' chunk states) is not in
    it;
  * collectives (``per_op {count, bytes}``, the reference's shape),
    three kinds: the node axis's exchange from
    :func:`repro_torch.distributed.aggregation.comm_bytes_per_step`
    (``collective-permute`` for the gossip strategies, ``all-reduce``
    for the exact mean), when the node axes span more than one device;
    the model axis's ``all-reduce`` of each matrix product one of whose
    operands is a weight matrix (its transpose, or a cast copy of
    either) with its contracted dimension sharded on 'model'; and the
    serving layout's ``all-gather`` of every weight sharded over the
    data axes, once a step;
  * roofline — the three terms over :mod:`repro_torch.launch.mesh`'s H100
    constants; ``model_flops`` is the reference's formula exactly.

No calibration.  The reference fits two depths × three sequence lengths
(its ``calibrate``) because XLA's cost analysis counts a ``lax.scan``
body once; the port's step runs every layer, so its counts are taken
as they come (``cost`` and ``cost_raw`` are the same numbers).

Per device.  A train step is run for node 0 alone (its loss and
gradient), then the node-stacked optimizer update and aggregation once;
node 0's counts stand for each of the ``n_nodes`` nodes (every node
runs the same shapes).  The step's whole counts are divided by the
devices: a train step's per-device counts are so one node's divided by
the 'model' axis (plus its share of the stacked update), a serving
step's the step's divided by every device.  The peak per device is the
local argument bytes plus the temporaries divided likewise.  Kernel
launches are the whole step's (every node's).

Every combination that raises is recorded as ``FAILED`` with its
traceback, and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.aggregation import (
    RULE_FOR_STRATEGY, _split_local, comm_bytes_per_step,
)
from repro_torch.distributed.consensus import get_rule
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gossip_axpy as _ga
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (
    HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16, make_production_mesh,
    n_chips, node_axes,
)
from repro_torch.launch.shapes import SHAPES, InputShape
from repro_torch.launch.sharding import axis_names, local_bytes
from repro_torch.launch.specs import (
    input_specs, make_aggregation, make_optimizer,
)
from repro_torch.models import transformer as tfm
from repro_torch.utils.trees import tree_leaves, tree_map

aten = torch.ops.aten
_MATMULS = {aten.mm.default: 0, aten.bmm.default: 0, aten.addmm.default: 1,
            aten.baddbmm.default: 1}            # → index of the first factor
_COPIES = (aten._to_copy.default, aten.clone.default)
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}
# (operations, bytes) of one call of each kernel a wrapper stands in for
_KERNEL_COST = {"flash_attention": _fa.cost, "ssd_scan": _ssd.cost,
                "gossip_combine": _ga.combine_cost}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def spec_pairs(args, specs):
    """(tensor, spec) of every tensor leaf of ``args``, walking the spec
    tree beside it (whose tuples are leaves)."""
    if isinstance(args, torch.Tensor):
        return [(args, specs)]
    if isinstance(args, dict):
        return [p for k in args for p in spec_pairs(args[k], specs[k])]
    if isinstance(args, (list, tuple)):
        return [p for a, s in zip(args, specs, strict=True)
                for p in spec_pairs(a, s)]
    return []                       # None, a decode state's int position


class _Meter(TorchDispatchMode):
    """Counts, over the ops dispatched inside it: the bytes each op reads
    and writes; the live bytes of meta storages and their peak; the
    'model' axis all-reduces (see the module docstring).  ``weights``
    maps a weight matrix's storage to the 'model' sharding of its rows
    and columns, with their sizes."""

    def __init__(self, weights: dict):
        super().__init__()
        self.weights = weights
        self.kernel_flops = self.kernel_bytes = 0
        self.bytes = 0
        self.live: dict[int, int] = {}
        self.cur = self.peak = 0
        self.allreduce = {"count": 0, "bytes": 0}

    def hold(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self.live:
            return
        n = s.nbytes()
        self.live[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)
        weakref.finalize(s, self._free, key)

    def kernel(self, name: str, *args, **kwargs) -> None:
        """A kernel wrapper's stand-in (``_build.recording``'s
        ``on_meta``): its operations and bytes."""
        flops, n_bytes = _KERNEL_COST[name](*args, **kwargs)
        self.kernel_flops += flops
        self.kernel_bytes += n_bytes

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def _weight(self, t, contracted_last: bool):
        """Whether operand ``t``'s contracted dim (its last for the first
        factor, its second to last for the second) is a weight matrix's
        dim sharded on 'model'; None when ``t`` is no weight matrix."""
        tag = self.weights.get(t.untyped_storage()._cdata)
        if tag is None or t.ndim < 2:
            return None
        (rows_m, cols_m), (rows, cols) = tag
        shape = tuple(t.shape[-2:])
        if t.stride(-1) == 1 and shape == (rows, cols):
            return cols_m if contracted_last else rows_m
        if t.stride(-2) == 1 and shape == (cols, rows):
            return rows_m if contracted_last else cols_m
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if func.is_view:
            return out
        if func.overloadpacket not in _ALLOCS:
            ins = _tensors(args) + _tensors(kwargs)
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self.hold(t)
        if func in _MATMULS:
            i = _MATMULS[func]
            a, b = args[i], args[i + 1]
            if self._weight(a, True) or self._weight(b, False):
                self.allreduce["count"] += 1
                self.allreduce["bytes"] += _nbytes(outs[0])
        elif func in _COPIES and outs:
            src = args[0]
            tag = self.weights.get(src.untyped_storage()._cdata)
            if (tag is not None and src.ndim >= 2
                    and outs[0].shape == src.shape):
                transposed = src.stride(-1) != 1
                (rm, cm), (r, c) = tag
                self.weights[outs[0].untyped_storage()._cdata] = (
                    ((cm, rm), (c, r)) if transposed else tag)
        return out


def _weight_tags(pairs) -> dict:
    """Storage → ((rows on 'model', cols on 'model'), (rows, cols)) of
    every argument leaf with a 'model'-sharded trailing matrix dim."""
    tags = {}
    for t, s in pairs:
        if t.ndim < 2 or len(s) < 2:
            continue
        rows_m = "model" in axis_names(s[-2])
        cols_m = "model" in axis_names(s[-1])
        if rows_m or cols_m:
            tags[t.untyped_storage()._cdata] = (
                (rows_m, cols_m), tuple(t.shape[-2:]))
    return tags


def _snapshot(meter, fc) -> dict:
    return {"flops": fc.get_total_flops() + meter.kernel_flops,
            "bytes": meter.bytes + meter.kernel_bytes,
            "allreduce_count": meter.allreduce["count"],
            "allreduce_bytes": meter.allreduce["bytes"],
            "launches": dict(_build.LAUNCHES)}


def _run_train(spec, fused: bool, aggregation, t_con, wire_dtype, marks,
               meter, fc):
    """The train step with node 0 alone traced (the module docstring);
    ``marks`` gets the counts just before and just after node 0."""
    state, batch = spec.args
    n_nodes = tree_leaves(batch)[0].shape[0]
    cfg = spec.cfg
    plan = tfm.build_plan(cfg)

    def losses_and_grads():
        grads = tree_map(torch.empty_like, state.params)
        marks.append(_snapshot(meter, fc))
        if not fused:
            steps_lib.node_loss(state.params, batch, cfg, 0)
        loss = steps_lib.node_loss_and_grad(state.params, batch, cfg, 0,
                                            grads, plan)
        marks.append(_snapshot(meter, fc))
        return torch.stack([loss] * n_nodes), grads

    return steps_lib.train_step_from(
        state, losses_and_grads, make_optimizer(cfg),
        make_aggregation(aggregation, t_con, wire_dtype))


def _node_collectives(params, agg, n_nodes: int, model_size: int) -> dict:
    """The node axis's exchange a step, per device: a node's
    :func:`comm_bytes_per_step` over the 'model' axis its replica spans."""
    mask = _split_local(params, agg.local_patterns)
    comm = [x for x, m in zip(tree_leaves(params), tree_leaves(mask))
            if m]
    if not comm:
        return {}
    n_comm = sum(x.numel() for x in comm) // n_nodes
    itemsize = (torch.finfo(getattr(torch, agg.wire_dtype)).bits // 8
                if agg.wire_dtype else comm[0].element_size())
    sig = get_rule(RULE_FOR_STRATEGY[agg.strategy]).signature(
        agg.t_con, d=n_comm, r=1, compression_k=agg.compression_k,
        compression=agg.compression)
    total = comm_bytes_per_step(n_comm, itemsize, agg, n_nodes)
    if sig.pattern == "none" or not total:
        return {}
    if sig.pattern == "central":
        return {"all-reduce": {"count": len(comm),
                               "bytes": total / model_size}}
    rounds = sig.rounds_per_iter * len(agg.shifts)
    return {"collective-permute": {"count": rounds * len(comm),
                                   "bytes": total / model_size}}


def _fsdp_gathers(pairs, mesh) -> dict:
    """The serving layout's all-gather of each weight sharded over the
    data axes, its gathered block's bytes, once a step."""
    data = {"pod", "data"}
    count, n_bytes = 0, 0
    for t, s in pairs:
        axes = [a for e in s for a in axis_names(e) if a in data]
        if not axes:
            continue
        ways = 1
        for a in axes:
            ways *= mesh.shape[a]
        count += 1
        n_bytes += local_bytes(t, s, mesh) * ways
    return {"all-gather": {"count": count, "bytes": n_bytes}} if count else {}


def _batch_ways(spec, mesh) -> int:
    """The devices a serving step's batch is split over."""
    s = (spec.in_shardings[1]["tokens"] if spec.kind == "prefill"
         else spec.in_shardings[2])
    ways = 1
    if s and s[0] is not None:
        for a in axis_names(s[0]):
            ways *= mesh.shape[a]
    return ways


def roofline_terms(flops_per_dev, hbm_bytes_per_dev, coll_bytes_per_dev):
    """The three roofline terms in seconds on one H100."""
    return {"compute_s": flops_per_dev / PEAK_FLOPS_BF16,
            "memory_s": hbm_bytes_per_dev / HBM_BW,
            "collective_s": coll_bytes_per_dev / NVLINK_BW}


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense, train) / 6·N_active·D; 2·N·D for pure
    forward (prefill), 2·N_active per decoded token."""
    n_act = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_act * tokens


def mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.sizes)


def measure(spec, mesh, *, fused: bool = True, aggregation="diffusion",
            t_con: int = 1, wire_dtype=None) -> dict:
    """Run ``spec``'s step once on its meta arguments → the memory, cost,
    collective and launch figures of the module docstring."""
    chips = n_chips(mesh)
    pairs = [p for a, s in zip(spec.args, spec.in_shardings, strict=True)
             for p in spec_pairs(a, s)]
    arg_global = sum(_nbytes(t) for t, _ in pairs)
    meter = _Meter(_weight_tags(pairs))
    for t, _ in pairs:
        meter.hold(t)
    _build.LAUNCHES.clear()
    marks: list = []
    with _build.recording(meter.kernel), ops.backend_scope("cuda"), \
            FlopCounterMode(display=False) as fc, meter:
        out = (_run_train(spec, fused, aggregation, t_con, wire_dtype,
                          marks, meter, fc)
               if spec.kind == "train" else spec.step_fn(*spec.args))
        end = _snapshot(meter, fc)
    held = {t.untyped_storage()._cdata for t, _ in pairs}
    out_bytes = sum(_nbytes(t) for t in _tensors(out)
                    if t.untyped_storage()._cdata not in held)
    total = {k: v for k, v in end.items() if k != "launches"}
    launches = dict(end["launches"])
    if spec.kind == "train":        # node 0 stands for every node
        n_nodes = tree_leaves(spec.args[1])[0].shape[0]
        before, after = marks
        for k in total:
            total[k] += (n_nodes - 1) * (after[k] - before[k])
        for name, n in after["launches"].items():
            launches[name] += (n_nodes - 1) * (
                n - before["launches"].get(name, 0))
        # one node's all-reduces, on its own 'model' group
        allreduce = {
            "count": after["allreduce_count"] - before["allreduce_count"],
            "bytes": after["allreduce_bytes"] - before["allreduce_bytes"]}
    else:
        allreduce = {"count": total["allreduce_count"],
                     "bytes": total["allreduce_bytes"]
                     / _batch_ways(spec, mesh)}
    per_op = {}
    if allreduce["count"] and mesh.shape.get("model", 1) > 1:
        per_op["all-reduce"] = allreduce
    if spec.kind == "train":
        node_devs = 1
        for a in node_axes(mesh):
            node_devs *= mesh.shape[a]
        if node_devs > 1:
            for op, v in _node_collectives(
                    spec.args[0].params, make_aggregation(
                        aggregation, t_con, wire_dtype), n_nodes,
                    mesh.shape.get("model", 1)).items():
                prev = per_op.get(op, {"count": 0, "bytes": 0})
                per_op[op] = {"count": prev["count"] + v["count"],
                              "bytes": prev["bytes"] + v["bytes"]}
    else:
        per_op.update(_fsdp_gathers(spec_pairs(spec.args[0],
                                               spec.in_shardings[0]), mesh))
    coll = {"per_op": per_op,
            "total_bytes": sum(v["bytes"] for v in per_op.values()),
            "total_count": sum(v["count"] for v in per_op.values())}
    arg_local = sum(local_bytes(t, s, mesh) for t, s in pairs)
    temp = (meter.peak - arg_global) / chips
    return {
        "memory": {"argument_bytes": arg_local,
                   "output_bytes": out_bytes / chips,
                   "temp_bytes": temp,
                   "peak_bytes": arg_local + temp,
                   "fits_device": arg_local + temp <= HBM_BYTES},
        "flops": total["flops"] / chips,
        "bytes_accessed": total["bytes"] / chips,
        "collectives": coll,
        "kernel_launches": launches,
        "argument_bytes_global": arg_global,
        "peak_bytes_global": meter.peak,
    }


def dominant_collective(stats: dict) -> str:
    if not stats["per_op"]:
        return "none"
    return max(stats["per_op"].items(), key=lambda kv: kv[1]["bytes"])[0]


def run_one(arch: str, shape_name, multi_pod: bool = False, *,
            aggregation: str = "diffusion", t_con: int = 1,
            fused: bool = True, mesh=None, cfg=None, n_nodes=None,
            **variant) -> dict:
    """One combination's record.  ``mesh`` (default: the production mesh
    of ``multi_pod``), ``cfg`` (default: ``get_config(arch)``),
    ``shape_name`` (a name or an InputShape) and ``n_nodes`` let a
    caller predict a host's own run (``chip_smoke.py`` on one card)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cfg = cfg or get_config(arch)
    shape = (shape_name if isinstance(shape_name, InputShape)
             else SHAPES[shape_name])
    t0 = time.time()
    spec = input_specs(cfg, shape, mesh, aggregation=aggregation,
                       t_con=t_con, fused=fused, n_nodes=n_nodes, **variant)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_tag(mesh),
        "chips": n_chips(mesh), "kind": spec.kind,
        "aggregation": aggregation if spec.kind == "train" else None,
        "t_con": t_con if spec.kind == "train" else None,
        "variant": {k: v for k, v in variant.items() if v},
        "note": spec.note, "status": "ok",
    }
    m = measure(spec, mesh, fused=fused, aggregation=aggregation,
                t_con=t_con, wire_dtype=variant.get("wire_dtype"))
    rec["lower_s"] = round(time.time() - t0, 2)     # the meta run
    rec["compile_s"] = 0.0                          # nothing is compiled
    rec["memory"] = m["memory"]
    coll = m["collectives"]
    rec["cost"] = {"flops": m["flops"], "bytes_accessed": m["bytes_accessed"],
                   "collective_bytes": coll["total_bytes"]}
    rec["collectives"] = coll
    rec["dominant_collective"] = dominant_collective(coll)
    rec["cost_raw"] = dict(rec["cost"],
                           caveat="every layer is run on the meta device: "
                                  "no calibration, cost == cost_raw")
    rec["kernel_launches"] = m["kernel_launches"]
    rec["argument_bytes_global"] = m["argument_bytes_global"]
    terms = roofline_terms(m["flops"], m["bytes_accessed"],
                           coll["total_bytes"])
    mf = model_flops(spec.cfg, shape)
    total_flops = m["flops"] * n_chips(mesh)
    rec["roofline"] = {
        **terms,
        "dominant": max(terms, key=terms.get).replace("_s", ""),
        "model_flops_total": mf,
        "hlo_flops_total": total_flops,
        "useful_flops_ratio": mf / total_flops if total_flops else None,
    }
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--aggregation", default="diffusion")
    ap.add_argument("--t-con", type=int, default=1)
    ap.add_argument("--no-fused", action="store_true")
    ap.add_argument("--wire-dtype", default=None)
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--shard-cache-slots", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shape_names = (list(SHAPES) if args.shape == "all"
                   else args.shape.split(","))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_start = time.time()
    for arch in archs:
        for sname in shape_names:
            for multi in meshes:
                tag = f"{arch}_{sname}_{'2x16x16' if multi else '16x16'}"
                if args.tag:
                    tag += f"_{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    try:
                        with open(path) as f:
                            if json.load(f).get("status") == "ok":
                                print(f"{tag}: skip (exists)", flush=True)
                                continue
                    except (OSError, ValueError):
                        pass
                try:
                    rec = run_one(arch, sname, multi,
                                  aggregation=args.aggregation,
                                  t_con=args.t_con,
                                  fused=not args.no_fused,
                                  wire_dtype=args.wire_dtype,
                                  remat_policy=args.remat_policy,
                                  shard_cache_slots=args.shard_cache_slots)
                except Exception as e:              # record, keep going
                    failures += 1
                    rec = {"arch": arch, "shape": sname,
                           "mesh": "2x16x16" if multi else "16x16",
                           "status": "FAILED", "error": repr(e),
                           "traceback": traceback.format_exc()}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                r = rec.get("roofline", {})
                print(f"{tag}: {rec['status']}"
                      + (f" dom={r.get('dominant')}"
                         f" compute={r.get('compute_s', 0):.2e}s"
                         f" mem={r.get('memory_s', 0):.2e}s"
                         f" coll={r.get('collective_s', 0):.2e}s"
                         f" peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB"
                         f" lower={rec.get('lower_s')}s"
                         if rec["status"] == "ok" else ""),
                      flush=True)
    print(f"done in {time.time() - t_start:.1f}s; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
