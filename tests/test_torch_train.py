"""The port's trainer against the JAX package's, on the CPU: schedules,
optimizers, clipping, the aggregation strategies and their pricing, and
the train steps of the smoke qwen3-1.7b (mamba2-130m's are in
``tests/test_torch_train_ssm.py``).  The tolerances, and why, are in the
docstring of ``tests/torch_train_parity.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as ropt  # noqa: E402
from repro.distributed import aggregation as ragg  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.distributed import aggregation as tagg  # noqa: E402
from repro_torch.utils.trees import tree_leaves_with_path  # noqa: E402
from torch_train_parity import (  # noqa: E402,F401
    BF16_ULP, EXACT, LOCAL, N_NODES, SCHED_RTOL, agg_pair, close_trees,
    leaf_paths, one_torch_thread, train_setup, check_reference_step,
    check_train_step,
)


# ---------------------------------------------------------------- trees

def test_tree_helpers_match_jax():
    from repro.utils import trees as rtrees
    from repro_torch.utils import trees as ttrees
    rng = np.random.default_rng(5)
    a, b = _random_tree(rng, "float64"), _random_tree(rng, "float64")
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = _to_torch(a), _to_torch(b)
    assert ttrees.tree_size(ta) == rtrees.tree_size(ja)
    assert ttrees.tree_bytes(ta) == rtrees.tree_bytes(ja)
    assert ttrees.tree_bytes(ttrees.tree_cast(ta, torch.bfloat16)) == \
        rtrees.tree_bytes(rtrees.tree_cast(ja, jnp.bfloat16))
    for got, want in ((ttrees.tree_dot(ta, tb), rtrees.tree_dot(ja, jb)),
                      (ttrees.tree_norm(ta), rtrees.tree_norm(ja))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    for got, want in ((ttrees.tree_add(ta, tb), rtrees.tree_add(ja, jb)),
                      (ttrees.tree_scale(ta, 0.3), rtrees.tree_scale(ja, 0.3)),
                      (ttrees.tree_axpy(-1.5, ta, tb),
                       rtrees.tree_axpy(-1.5, ja, jb)),
                      (ttrees.tree_zeros_like(ta), rtrees.tree_zeros_like(ja))):
        close_trees(got, want, EXACT)
    assert [p for p, _ in ttrees.tree_leaves_with_path(ta)] == list(
        leaf_paths(ja))
    assert ttrees.tree_unflatten(ta, ttrees.tree_leaves(tb)) == \
        ttrees.tree_map(lambda x: x, tb)


# ---------------------------------------------------------------- schedules

SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "linear_warmup": lambda m: m.linear_warmup(3e-4, 7),
    "cosine_decay": lambda m: m.cosine_decay(3e-4, 150, 1e-5),
    "warmup_cosine": lambda m: m.warmup_cosine(3e-4, 10, 150),
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_jax(name):
    steps = range(0, 200)
    want = np.array([float(SCHEDULES[name](ropt)(jnp.asarray(s, jnp.int32)))
                     for s in steps])
    got = np.array([float(SCHEDULES[name](topt)(
        torch.tensor(s, dtype=torch.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL,
                               atol=SCHED_RTOL * 3e-4)


# ---------------------------------------------------------------- optimizers

OPTIMIZERS = {
    "sgd": lambda m, s: m.sgd(s),
    "sgd_momentum": lambda m, s: m.sgd(s, momentum=0.9),
    "sgd_nesterov": lambda m, s: m.sgd(s, momentum=0.9, nesterov=True),
    "adam": lambda m, s: m.adam(s),
    "adamw": lambda m, s: m.adamw(s, weight_decay=0.1),
}
# float64 trees: schedules without a transcendental (bit-exact in both
# packages); float32: the cosine ones
SCHEDULE_FOR = {"float64": (lambda m: m.constant(1e-2),
                            lambda m: m.linear_warmup(1e-2, 3)),
                "float32": (lambda m: m.cosine_decay(1e-2, 5, 1e-4),
                            lambda m: m.warmup_cosine(1e-2, 2, 6))}


def _random_tree(rng, dtype, lead=()):
    shapes = {"embed": {"table": (11, 6)}, "final_norm": {"scale": (6,)},
              "lm_head": {"w": (6, 11)},
              "seg0": {"mixer": {"wq": {"w": (2, 6, 5)}},
                       "norm1": {"scale": (2, 6)}}}

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return rng.standard_normal(lead + node).astype(dtype)
    return make(shapes)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_match_jax(name, dtype):
    rng = np.random.default_rng(0)
    if dtype == "float32":
        tol = dict(rtol=SCHED_RTOL, atol=1e-9)
    elif name.startswith("adam"):
        tol = dict(rtol=2.0 ** -22, atol=1e-12)
    else:
        tol = EXACT
    for sched in SCHEDULE_FOR[dtype]:
        params = _random_tree(rng, dtype)
        grads = [_random_tree(rng, dtype) for _ in range(4)]
        jo = OPTIMIZERS[name](ropt, sched(ropt))
        to = OPTIMIZERS[name](topt, sched(topt))
        jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
        js, ts = jo.init(jp), to.init(tp)
        for g in grads:
            ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
            tu, ts = to.update(_to_torch(g), ts, tp)
            close_trees(tu, ju, tol)
            jp, tp = ropt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
            close_trees(tp, jp, tol)
            assert int(ts["step"]) == int(js["step"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_clip_by_global_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    grads = _random_tree(rng, dtype)
    tol = EXACT if dtype == "float64" else dict(rtol=1e-6, atol=0.0)
    for max_norm in (0.5, 1e3):
        jg, jn = ropt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                          max_norm)
        tg, tn = topt.clip_by_global_norm(_to_torch(grads), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        close_trees(tg, jg, dict(rtol=1e-6, atol=0.0) if max_norm < 1
                     else tol)
        assert {x.dtype for x in jax.tree.leaves(tg)} == {
            getattr(torch, dtype)}


# ---------------------------------------------------------------- aggregation

@pytest.mark.parametrize("strategy", ragg.STRATEGIES)
def test_aggregation_matches_jax(strategy):
    """Both hooks of every strategy on a random node-stacked float64
    tree, with and without node-local leaves, two gossip rounds and a
    third shift."""
    rng = np.random.default_rng(2)
    tree = _random_tree(rng, "float64", lead=(N_NODES,))
    for kw in (dict(), dict(local_patterns=LOCAL, t_con=2,
                            shifts=(-1, 1, 2))):
        ja, ta = agg_pair(strategy=strategy, **kw)
        for hook in ("aggregate_gradients", "aggregate_params"):
            want = getattr(ragg, hook)(jax.tree.map(jnp.asarray, tree), ja)
            got = getattr(tagg, hook)(_to_torch(tree), ta)
            if strategy != "quantized" or hook == "aggregate_gradients":
                close_trees(got, want, EXACT)
            else:            # the rule's default bf16 wire
                close_trees(got, want, dict(rtol=BF16_ULP, atol=0.0))
        if kw:
            got = tagg.aggregate_params(_to_torch(tree), ta)
            for path in ("embed/table", "lm_head/w"):
                np.testing.assert_array_equal(leaf_paths(got)[path],
                                              leaf_paths(tree)[path])


@pytest.mark.parametrize("strategy", [s for s in ragg.STRATEGIES
                                      if s != "local"])
def test_bf16_wire_matches_jax(strategy):
    rng = np.random.default_rng(3)
    tree = _random_tree(rng, "float32", lead=(N_NODES,))
    ja, ta = agg_pair(strategy=strategy, wire_dtype="bfloat16",
                       local_patterns=LOCAL)
    for hook in ("aggregate_gradients", "aggregate_params"):
        want = getattr(ragg, hook)(jax.tree.map(jnp.asarray, tree), ja)
        got = getattr(tagg, hook)(_to_torch(tree), ta)
        close_trees(got, want, dict(rtol=BF16_ULP, atol=0.0))


def test_split_local_matches_jax_on_the_model_trees():
    for arch in ("qwen3-1.7b", "mamba2-130m"):
        _, _, params, tparams = train_setup(arch, "float32")[:4]
        for patterns in ((), LOCAL, ("norm", r"mixer/w[qk]")):
            want = jax.tree_util.tree_flatten_with_path(
                ragg._split_local(params, patterns))[0]
            want = {"/".join(str(k.key) for k in p): m for p, m in want}
            got = dict(tree_leaves_with_path(
                tagg._split_local(tparams, patterns)))
            assert got == want


KNOBS = {"allreduce": [{}], "diffusion": [{}], "consensus": [{}],
         "dgd": [{}], "local": [{}],
         "topk": [{}, dict(compression_k=5), dict(compression_k=999)],
         "quantized": [{}, dict(compression="bf16"),
                       dict(compression="int8"),
                       dict(compression="int8_stochastic")]}


@pytest.mark.parametrize("strategy", ragg.STRATEGIES)
def test_comm_bytes_per_step_matches_jax(strategy):
    for knobs in KNOBS[strategy]:
        for t_con, shifts in ((1, (-1, 1)), (3, (-1, 1, -4, 4))):
            ja, ta = agg_pair(strategy=strategy, t_con=t_con,
                               shifts=shifts, **knobs)
            for n, itemsize, nodes in ((1000, 4, 4), (123457, 2, 16)):
                assert tagg.comm_bytes_per_step(n, itemsize, ta, nodes) == \
                    ragg.comm_bytes_per_step(n, itemsize, ja, nodes)


CONFIG_CASES = [dict(strategy="gossip"), dict(strategy="diffusion",
                                              compression_k=4),
                dict(strategy="quantized", compression_k=4),
                dict(strategy="topk", compression="int8"),
                dict(strategy="local", compression="bf16"),
                dict(strategy="topk", compression_k=4),
                dict(strategy="quantized", compression="int8"),
                dict(strategy="allreduce", wire_dtype="bfloat16")]


@pytest.mark.parametrize("case", range(len(CONFIG_CASES)))
def test_aggregation_config_errors_match_jax(case):
    kw = CONFIG_CASES[case]
    try:
        ragg.AggregationConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tagg.AggregationConfig(**kw)
        assert str(got.value) == str(e)
    else:
        assert dataclasses.asdict(tagg.AggregationConfig(**kw)) == \
            dataclasses.asdict(ragg.AggregationConfig(**kw))


# ---------------------------------------------------------------- train step

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("strategy", ragg.STRATEGIES)
def test_train_step_matches_jax(strategy, dtype):
    """Three steps of the port's fused step (and, at float32, of the
    unfused one) against the JAX package's; float32 also the first
    step's per-node gradients."""
    check_train_step("qwen3-1.7b", strategy, dtype)


def test_reference_step_is_jax_make_train_step():
    check_reference_step("qwen3-1.7b")


def test_ssd_chunked_gradient_is_finite_where_the_reference_overflows():
    """At dt·A of mamba2-130m's scale (−1.6 a token, −205 over a chunk of
    128) the intra-chunk decay exp(cum_i − cum_j) overflows above the
    diagonal: the JAX package's ``ssd_chunked`` masks after the exp and
    its gradient is NaN there; the port's masks before, with the same
    values (the models' f32 tolerance) and a finite gradient, equal to
    the token-by-token recurrence's (both compute in float32: rtol
    1e-4)."""
    import repro.models.ssm as rssm
    from repro_torch.kernels import ref as tref
    from repro_torch.models import ssm as tssm
    rng = np.random.default_rng(6)
    B, S, H, P, N, Q = 1, 256, 3, 8, 16, 128
    x, Bm, Cm = (rng.standard_normal(s) for s in
                 ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = np.full((B, S, H), 0.1)
    A, D = -np.array([1.0, 8.0, 16.0]), np.ones(H)
    args32 = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]
    want = rssm.ssd_chunked(*map(jnp.asarray, args32), Q)[0]
    got = tssm.ssd_chunked(*map(torch.from_numpy, args32), Q)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jgrad = jax.grad(lambda a: rssm.ssd_chunked(
        *map(jnp.asarray, (args32[0], args32[1])), a,
        *map(jnp.asarray, args32[3:]), Q)[0].sum())(jnp.asarray(args32[2]))
    assert np.isnan(np.asarray(jgrad)).any()

    def grad_A(fn):
        a = torch.from_numpy(A).requires_grad_()
        t = [torch.from_numpy(v) for v in (x, dt, Bm, Cm, D)]
        fn(t[0], t[1], a, t[2], t[3], t[4]).sum().backward()
        return a.grad
    g = grad_A(lambda *a: tssm.ssd_chunked(*a, Q)[0])
    assert bool(torch.isfinite(g).all())
    torch.testing.assert_close(g, grad_A(lambda *a: tref.ref_ssd(*a)[0]),
                               rtol=1e-4, atol=1e-6)
