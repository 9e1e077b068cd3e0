"""input_specs — meta-device stand-ins and spec trees for every (arch ×
input shape × mesh) combination.  Port of ``src/repro/launch/specs.py``:
no memory is allocated (the tensors live on the ``meta`` device, which
has shapes and dtypes and no data), and the dry run
(:mod:`repro_torch.launch.dryrun`) runs the step on them.

Deviations from the reference, each the port's own form of the same
thing:
  * specs are tuples, not ``NamedSharding`` objects
    (:mod:`repro_torch.launch.sharding`);
  * tokens and labels are int64 (torch's index dtype), the reference's
    int32, and a cache's slot positions are int64 likewise;
  * the serving parameters are the port's serving copy
    (:func:`repro_torch.models.transformer.serving_params`: linear
    weights and expert stacks in the activation dtype; the embedding,
    norms, router and SSM leaves keep theirs), where the reference casts
    every floating leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.distributed.aggregation import AggregationConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shapes as shapes_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.utils.trees import tree_map

META = torch.device("meta")


class DryRunSpec(NamedTuple):
    step_fn: Any              # the step function, called on ``args``
    args: tuple               # trees of meta tensors
    in_shardings: tuple       # the matching spec trees
    kind: str                 # train | prefill | decode
    cfg: Any                  # the (possibly variant) ModelConfig used
    note: str


def abstract_params(cfg, n_nodes: int | None = None):
    """The parameter tree as meta tensors (``init_params`` on the meta
    device, which draws nothing), optionally stacked on a leading node
    axis of ``n_nodes``."""
    params = tfm.init_params(cfg, device=META)
    if n_nodes:
        params = tree_map(lambda x: torch.empty((n_nodes, *x.shape),
                                                dtype=x.dtype, device=META),
                          params)
    return params


def batch_struct(cfg, batch: int, seq: int, lead_nodes: int | None = None):
    """The abstract input batch of one step (labels included): a vlm's
    ``vis_tokens`` patch embeddings and ``seq − vis_tokens`` text
    tokens."""
    def empty(shape, dtype):
        lead = (lead_nodes,) if lead_nodes else ()
        return torch.empty((*lead, *shape), dtype=dtype, device=META)

    s_text = seq - cfg.vis_tokens if cfg.modality == "vlm" else seq
    b = {"tokens": empty((batch, s_text), torch.int64)}
    if cfg.modality == "vlm":
        b["vis_embed"] = empty((batch, cfg.vis_tokens, cfg.d_model),
                               getattr(torch, cfg.dtype))
    b["labels"] = empty((batch, s_text), torch.int64)
    return b


def make_optimizer(cfg):
    return adamw(warmup_cosine(3e-4, 200, 10_000), weight_decay=0.1)


def make_aggregation(aggregation: str = "diffusion", t_con: int = 1,
                     wire_dtype: str | None = None) -> AggregationConfig:
    """The trainer's aggregation: the embedding and LM head node-local."""
    return AggregationConfig(strategy=aggregation, t_con=t_con,
                             local_patterns=("embed", "lm_head"),
                             wire_dtype=wire_dtype)


def input_specs(arch_cfg, shape_name, mesh, *,
                aggregation: str = "diffusion", t_con: int = 1,
                fused: bool = True, wire_dtype: str | None = None,
                remat_policy: str | None = None,
                shard_cache_slots: bool = False,
                n_nodes: int | None = None) -> DryRunSpec:
    """(step_fn, abstract args, spec trees) of one combination.
    ``shape_name`` may be an :class:`~repro_torch.launch.shapes.InputShape`;
    ``mesh`` a :class:`~repro_torch.launch.mesh.MeshShape`.  ``n_nodes``
    (training) overrides the node count the mesh's node axes give, for a
    host that holds several replicas on one device."""
    shape = (shape_name if isinstance(shape_name, shapes_lib.InputShape)
             else shapes_lib.get_shape(shape_name))
    model_size = mesh.shape.get("model", 1)
    note = ""
    cfg = arch_cfg
    if remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)

    if shape.kind == "train":
        nodes = n_nodes or mesh_lib.n_nodes(mesh)
        lead = mesh_lib.node_axes(mesh)
        if shape.global_batch % nodes:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {nodes} nodes")
        per_node = shape.global_batch // nodes
        params = abstract_params(cfg, nodes)
        opt = make_optimizer(cfg)
        opt_state = opt.init(params)
        state = steps_lib.TrainState(
            params=params, opt_state=opt_state,
            step=torch.zeros((), dtype=torch.int32, device=META))
        batch = batch_struct(cfg, per_node, shape.seq_len, lead_nodes=nodes)
        agg = make_aggregation(aggregation, t_con, wire_dtype)
        make = (steps_lib.make_train_step_fused if fused
                else steps_lib.make_train_step)
        step = make(cfg, opt, agg, nodes)
        pspec = shard_lib.param_specs(params, lead=lead,
                                      model_size=model_size)
        ospec = shard_lib.param_specs(opt_state, lead=lead,
                                      model_size=model_size)
        state_spec = steps_lib.TrainState(params=pspec, opt_state=ospec,
                                          step=())
        bspec = shard_lib.batch_specs(batch, lead)
        return DryRunSpec(step_fn=step, args=(state, batch),
                          in_shardings=(state_spec, bspec), kind="train",
                          cfg=cfg, note=note)

    # ---------------- serving: one parameter copy ----------------------
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_batch_devs = 1
    for a in batch_axes:
        n_batch_devs *= mesh.shape[a]

    if shape.name == "long_500k":
        cfg, note = shapes_lib.long_ctx_variant(cfg)

    params = tfm.serving_params(abstract_params(cfg), cfg)
    # 2-D weight sharding ('model' × data axes): the only serving layout
    # in which the 480B/671B archs fit
    pspec = shard_lib.param_specs(params, lead=None, model_size=model_size,
                                  fsdp_axes=batch_axes,
                                  fsdp_size=n_batch_devs)
    lead = batch_axes if shape.global_batch % n_batch_devs == 0 else None

    if shape.kind == "prefill":
        batch = batch_struct(cfg, shape.global_batch, shape.seq_len)
        del batch["labels"]
        bspec = shard_lib.batch_specs(batch, lead)
        return DryRunSpec(step_fn=steps_lib.make_prefill_step(cfg),
                          args=(params, batch), in_shardings=(pspec, bspec),
                          kind="prefill", cfg=cfg, note=note)

    cap = shapes_lib.cache_capacity(cfg, shape)
    state = tfm.init_cache(cfg, batch=shape.global_batch, capacity=cap,
                           device=META)
    if lead is None:
        note = (note + " | " if note else "") + (
            f"batch {shape.global_batch} < {n_batch_devs} node devices — "
            "cache replicated over data axes, weights sharded on 'model'")
    cspec = shard_lib.cache_specs(state, lead, cfg, shard_heads=False,
                                  shard_slots=shard_cache_slots)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int64,
                         device=META)
    tspec = shard_lib.spec(lead) if lead else ()
    return DryRunSpec(step_fn=steps_lib.make_serve_step(cfg),
                      args=(params, state, tokens),
                      in_shardings=(pspec, cspec, tspec), kind="decode",
                      cfg=cfg, note=note)
