"""The port's trainer on its own, on the CPU (no JAX, but for the vlm
batches' shapes, held against the JAX package's): the aggregation
strategies' semantics on a real (smoke) model as
``tests/test_train_steps.py`` holds the JAX package's, fused ≡ unfused,
the bfloat16 wire, remat, the synthetic data, the autograd wrapper of
the kernels, and ``launch.train``.

Tolerances are the JAX package's own in ``tests/test_train_steps.py``:
replicas identical within rtol 1e-6 / atol 1e-7 (allreduce; here they
are bit for bit), rtol 1e-5 / atol 1e-6 after one exact-mean diffusion
round, fused ≡ unfused within rtol 1e-6 / atol 1e-7, the bfloat16 wire
within rtol 0.05 / atol 1e-2 of full precision.  Remat and the autograd
wrapper change no value: they are held bit for bit.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import (SyntheticLM, make_batch_for,  # noqa: E402
                              make_lm_batch, node_task_loader)
from repro_torch.data.pipeline import fold_generator  # noqa: E402
from repro_torch.distributed.aggregation import AggregationConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import attention_dispatch  # noqa: E402
from repro_torch.optim import adamw, constant  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

N_NODES = 2


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen3-1.7b").smoke()
    params = steps_lib.replicate_for_nodes(
        tfm.init_params(cfg, seed=0, device="cpu"), N_NODES)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (N_NODES, 2, 16), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    return cfg, params, batch


def _run(cfg, params, batch, strategy, t_con=1, steps=3, fused=True,
         wire_dtype=None, **agg_kw):
    opt = adamw(constant(1e-3))
    state = steps_lib.TrainState(params, opt.init(params),
                                 torch.zeros((), dtype=torch.int32))
    agg = AggregationConfig(strategy=strategy, t_con=t_con,
                            wire_dtype=wire_dtype, **agg_kw)
    make = (steps_lib.make_train_step_fused if fused
            else steps_lib.make_train_step)
    step = make(cfg, opt, agg, N_NODES)
    for _ in range(steps):
        state, metrics = step(state, batch)
    return state, metrics


def test_allreduce_keeps_replicas_identical(setup):
    cfg, params, batch = setup
    state, _ = _run(cfg, params, batch, "allreduce")
    for leaf in tree_leaves(state.params):
        assert torch.equal(leaf[0], leaf[1])


def test_two_node_diffusion_equals_allreduce(setup):
    """With 2 nodes, one shift and self_weight 0.5, one diffusion round
    is the exact mean: after one step the replicas coincide."""
    cfg, params, batch = setup
    state, _ = _run(cfg, params, batch, "diffusion", steps=1, shifts=(1,),
                    self_weight=0.5)
    for leaf in tree_leaves(state.params):
        torch.testing.assert_close(leaf[0], leaf[1], rtol=1e-5, atol=1e-6)


def test_local_lets_replicas_diverge(setup):
    cfg, params, batch = setup
    state, _ = _run(cfg, params, batch, "local")
    assert any(not torch.allclose(leaf[0], leaf[1], atol=1e-7)
               for leaf in tree_leaves(state.params))


@pytest.mark.parametrize("strategy", ["allreduce", "diffusion", "topk"])
def test_local_leaves_are_never_mixed(setup, strategy):
    """After one step the node-local leaves are what the ``local``
    strategy leaves there, bit for bit, and the others are not."""
    cfg, params, batch = setup
    kw = dict(steps=1, local_patterns=("embed",))
    ref, _ = _run(cfg, params, batch, "local", **kw)
    got, _ = _run(cfg, params, batch, strategy, **kw)
    assert torch.equal(got.params["embed"]["table"],
                       ref.params["embed"]["table"])
    assert not torch.equal(got.params["seg0"]["mixer"]["wq"]["w"],
                           ref.params["seg0"]["mixer"]["wq"]["w"])


def test_fused_matches_unfused(setup):
    cfg, params, batch = setup
    s1, m1 = _run(cfg, params, batch, "diffusion", fused=True)
    s2, m2 = _run(cfg, params, batch, "diffusion", fused=False)
    torch.testing.assert_close(m1["loss_per_node"], m2["loss_per_node"],
                               rtol=1e-6, atol=0.0)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_wire_dtype_close_to_full_precision(setup):
    cfg, params, batch = setup
    s1, _ = _run(cfg, params, batch, "diffusion", steps=2)
    s2, _ = _run(cfg, params, batch, "diffusion", steps=2,
                 wire_dtype="bfloat16")
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        torch.testing.assert_close(a, b, rtol=0.05, atol=1e-2)


def test_train_step_rejects_a_wrong_node_axis(setup):
    cfg, params, batch = setup
    opt = adamw(constant(1e-3))
    step = steps_lib.make_train_step_fused(cfg, opt, AggregationConfig(),
                                           N_NODES + 1)
    with pytest.raises(ValueError, match="node axis"):
        step(steps_lib.TrainState(params, opt.init(params),
                                  torch.zeros((), dtype=torch.int32)), batch)


# ---------------------------------------------------------------- remat

@pytest.mark.parametrize("policy", ["all", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-130m"])
def test_remat_same_values_and_gradients(arch, policy, monkeypatch):
    """Checkpointing each block moves no value and no gradient, and
    does recompute: every block's forward runs twice under autograd,
    once without it."""
    cfg = get_config(arch).smoke()
    cfg_r = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    params = steps_lib.replicate_for_nodes(
        tfm.init_params(cfg, seed=2, device="cpu"), 1)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, 2, 16), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    calls = []
    real = blk.block_forward
    monkeypatch.setattr(blk, "block_forward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    l1, g1 = steps_lib.node_value_and_grad(params, batch, cfg, 1)
    assert len(calls) == cfg.n_layers
    calls.clear()
    l2, g2 = steps_lib.node_value_and_grad(params, batch, cfg_r, 1)
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    with torch.no_grad():
        steps_lib.loss_fn(steps_lib._node_slices(params, 0, lambda x: x,
                                                 tfm.build_plan(cfg)),
                          {k: v[0] for k, v in batch.items()}, cfg_r)
    assert len(calls) == cfg.n_layers
    assert torch.equal(l1, l2)
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- autograd

def test_with_plain_backward_gives_the_plain_gradient():
    """A kernel stand-in that returns the plain core's values with no
    autograd graph (as a ctypes call does), wrapped: the forward is its
    output, the gradients are the plain core's, bit for bit."""
    g = torch.Generator().manual_seed(4)
    B, S, H, Hkv, D = 2, 24, 4, 2, 16
    q, k, v = (torch.randn(shape, generator=g, dtype=torch.float32)
               for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    pos = torch.arange(S).expand(B, S)
    w = torch.randn((B, S, H, D), generator=g)

    def plain(q, k, v):
        return attention_dispatch(q, k, v, pos, pos, window=5)

    def stand_in(q, k, v):
        with torch.no_grad():
            return plain(q, k, v).clone()

    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.with_plain_backward(stand_in, plain, *qkv)
    got = torch.autograd.grad((out * w).sum(), qkv)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad((plain(*ref) * w).sum(), ref)
    assert torch.equal(out, plain(q, k, v))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # an input that needs no gradient gets none
    q2 = q.clone().requires_grad_()
    out = ops.with_plain_backward(stand_in, plain, q2, k, v)
    (gq,) = torch.autograd.grad((out * w).sum(), [q2])
    assert torch.equal(gq, want[0])


# ---------------------------------------------------------------- data

def test_synthetic_lm_shapes_determinism_and_markov_structure():
    V, S, B = 97, 40, 3
    ds = SyntheticLM(V, S, B, seed=5)
    b = ds.batch(2, node=1)
    toks = b["tokens"]
    assert toks.shape == (B, S) and toks.dtype == torch.int64
    assert int(toks.min()) >= 0 and int(toks.max()) < V
    assert torch.equal(toks, SyntheticLM(V, S, B, seed=5).batch(2, 1)
                       ["tokens"])
    for other in (ds.batch(3, 1), ds.batch(2, 0),
                  SyntheticLM(V, S, B, seed=6).batch(2, 1)):
        assert not torch.equal(toks, other["tokens"])
    # t_{i+1} = (7 t_i + eps + 3) mod V, eps in [0, 17)
    eps = (toks[:, 1:] - 7 * toks[:, :-1] - 3) % V
    assert int(eps.max()) < 17
    assert len(set(eps.flatten().tolist())) > 10
    assert torch.equal(next(iter(ds))["tokens"], ds.batch(0)["tokens"])


def test_lm_batches():
    cfg = get_config("qwen3-1.7b").smoke()
    b = make_batch_for(cfg, 3, 10, seed=1)
    assert b["tokens"].shape == (3, 10)
    assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, dims=1))
    assert torch.equal(b["tokens"], make_lm_batch(fold_generator(1), cfg, 3,
                                                  10)["tokens"])
    # the vlm's: patch embeddings, then the text; shapes and dtypes as the
    # JAX package's batches (imported here: the rest of the file runs
    # without jax)
    jax = pytest.importorskip("jax")
    from repro.data import pipeline as rpipeline
    from repro.launch import train as rtrain
    vlm = get_config("llava-next-mistral-7b").smoke()
    got = {"make_batch_for": make_batch_for(vlm, 2, 24, seed=1),
           "make_batch": train_lib.make_batch(vlm, fold_generator(0), 2, 3,
                                              24)}
    want = {"make_batch_for": rpipeline.make_batch_for(vlm, 2, 24, seed=1),
            "make_batch": rtrain.make_batch(vlm, jax.random.PRNGKey(0), 2,
                                            3, 24)}
    for name, b in got.items():
        assert {k: tuple(v.shape) for k, v in b.items()} == \
            {k: tuple(v.shape) for k, v in want[name].items()}, name
        assert b["vis_embed"].dtype == getattr(torch, vlm.dtype)
        assert str(want[name]["vis_embed"].dtype) == vlm.dtype
        assert b["tokens"].shape[-1] == 24 - vlm.vis_tokens
        assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, dims=-1))
        assert 0 <= int(b["tokens"].min()) <= int(b["tokens"].max()) < \
            vlm.vocab_size
        assert float(b["vis_embed"].std()) == pytest.approx(0.02, rel=0.2)


def test_node_task_loader_is_the_nodes_shard():
    from repro_torch.core.problem import generate_problem, split_samples
    prob = generate_problem(torch.Generator().manual_seed(0), d=12, T=8,
                            r=2, n=6, L=4, dtype=torch.float64)
    for problem in (prob, split_samples(prob, 2)):
        for g in range(4):
            shard = node_task_loader(problem, g)
            tasks = problem.tasks_per_node[g]
            assert torch.equal(shard["X"], problem.X[..., tasks, :, :])
            assert torch.equal(shard["y"], problem.y[..., tasks, :])


# ---------------------------------------------------------------- launcher

def test_train_runs_on_the_cpu_and_checkpoints(tmp_path):
    state, history = train_lib.train("mamba2-130m", steps=3, n_nodes=2,
                                     seq=16, ckpt_dir=str(tmp_path),
                                     device="cpu")
    assert len(history) == 3 and all(np.isfinite(history))
    assert int(state.step) == 3
    assert latest_step(str(tmp_path)) == 3
    back = restore_checkpoint(str(tmp_path), 3, state.params)
    for a, b in zip(tree_leaves(back), tree_leaves(state.params)):
        assert torch.equal(a, b)
    _, again = train_lib.train("mamba2-130m", steps=3, n_nodes=2, seq=16,
                               device="cpu")
    assert again == history


def test_train_cli_and_its_device_rule(monkeypatch, capsys):
    train_lib.main(["--arch", "qwen3-1.7b", "--steps", "2", "--nodes", "2",
                    "--seq", "8", "--layers", "1", "--aggregation", "dgd",
                    "--device", "cpu"])
    assert "final loss" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lib.train("qwen3-1.7b", steps=1)
