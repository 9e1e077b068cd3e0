"""Shared machinery of the trainer's cross-package tests
(``tests/test_torch_train.py``, ``tests/test_torch_train_ssm.py``): the
port's trainer against the JAX package's, on the CPU.

Inputs are made with numpy (or by the JAX package) and passed to both
packages as numpy.  Tolerances:

* schedules: float32 in both packages, rtol 1e-6 with atol 1e-6 × the
  peak (cos near −1 cancels: one ulp of cos is a large share of 1 + cos);
* optimizers and clipping on random trees: float64 trees with the
  constant and linear-warmup schedules ≤ 1e-12 (the moments and updates
  are float32 in both packages: SGD's agree to the bit); Adam within two
  float32 ulps (rtol 2^-22), since torch's vectorized CPU ``sqrt`` is
  off by one ulp on ~1 % of entries where XLA's is correctly rounded;
  the cosine schedules at rtol 1e-6 (one float32 ulp of cos);
* the 7 strategies' ``aggregate_gradients`` / ``aggregate_params`` on
  random node-stacked float64 trees with ``local_patterns`` ≤ 1e-12, the
  bfloat16 wire within one bfloat16 ulp (2^-8 relative);
* ``comm_bytes_per_step`` exactly, and ``AggregationConfig``'s errors
  case for case;
* ``make_train_step`` and ``make_train_step_fused`` of the smoke
  qwen3-1.7b and mamba2-130m, 4 nodes, 3 steps, on the JAX package's
  weights (``params_from_jax`` + ``replicate_for_nodes``) and batch:
  - float64 parameters and activations, SGD with momentum: parameters
    ≤ 1e-8 after every step, losses rtol 1e-6.  Both packages compute
    the norms, the attention and SSD cores and the logits in float32
    whatever the activation dtype, so their losses agree to float32
    precision, and Adam, whose update is ≈ lr·sign(g), would magnify the
    float32 noise of near-zero gradients to ~lr; SGD keeps the noise at
    lr × 1e-8.  Under ``quantized``'s bfloat16 wire a neighbour's entry
    that rounds the other way moves a mixed entry by a third of its
    bfloat16 ulp, at each of the three steps: its parameters are held
    within two bfloat16 ulps (2^-6) of each leaf's largest entry besides;
  - the JAX package's ``ssd_chunked`` takes ``exp`` before it masks the
    intra-chunk decay, so where cum_i − cum_j overflows its gradient is
    0·inf = NaN; the port masks first (the same values, a finite
    gradient).  Where a reference step's gradients hold NaN (mamba2's
    ``topk``, whose sparsified ``dt_bias`` makes dt·A large), that step's
    losses are compared, the port's parameters must be finite, and the
    comparison ends;
  - float32 (the smoke's dtype), AdamW as ``launch.train`` runs it:
    first-step gradients rtol 1e-4 / atol 1e-5, losses rtol 1e-4.  Under
    ``topk`` Adam's first updates, ±lr on most entries, leave magnitudes
    tied up to float32 rounding, and the two packages keep different
    entries among them; its losses after the first step are held at rtol
    2e-3, and its selection exactly by the float64 run.
  The JAX reference step is the body of ``make_train_step_fused`` — the
  JAX package's ``aggregate_gradients``, ``opt.update``,
  ``apply_updates`` and ``aggregate_params`` after a vmapped
  ``value_and_grad(loss_fn)``, each jitted apart so that the gradient's
  and the optimizer's compiles serve every strategy;
  :func:`check_reference_step` holds the JAX package's own jitted
  ``make_train_step_fused`` to the same numbers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
from repro import optim as ropt
from repro.distributed import aggregation as ragg
from repro.launch import steps as rsteps
from repro.launch import train as rtrain
from repro.models import init_params as rinit
from repro_torch.configs.base import ModelConfig
from repro_torch import optim as topt
from repro_torch.distributed import aggregation as tagg
from repro_torch.launch import steps as tsteps
from repro_torch.models import params_from_jax
from repro_torch.utils.trees import tree_leaves_with_path

N_NODES = 4
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The smoke models' operations are small: torch's intra-op threads
    only contend with XLA's and with the other test workers' (half the
    CPU time of a run, and none of its speed).  Restored after the
    module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
EXACT = dict(rtol=0.0, atol=1e-12)
SCHED_RTOL = 1e-6
BF16_ULP = 2.0 ** -8
LOSS_F64 = dict(rtol=1e-6, atol=0.0)
PARAM_F64 = dict(rtol=0.0, atol=1e-8)
LOSS_F32 = dict(rtol=1e-4, atol=0.0)
LOSS_F32_TOPK_LATER = dict(rtol=2e-3, atol=0.0)
GRAD_F32 = dict(rtol=1e-4, atol=1e-5)
LOCAL = ("embed", "lm_head")


def as_np(t):
    return t.detach().cpu().double().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float64)


def leaf_paths(tree):
    """{path: leaf as float64 numpy} of a port tree or a JAX tree."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {p: as_np(x) for p, x in tree_leaves_with_path(tree)}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): as_np(x) for path, x in flat}


def close_trees(got, want, tol):
    got, want = leaf_paths(got), leaf_paths(want)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **tol)


def agg_pair(**kw):
    return ragg.AggregationConfig(**kw), tagg.AggregationConfig(**kw)


def _tcfg(cfg):
    """The port's ModelConfig equal to the JAX package's ``cfg``."""
    return ModelConfig(**dataclasses.asdict(cfg))


def _torch_params(jparams, cfg):
    """The JAX package's parameters as the port's dict of CPU tensors."""
    model = params_from_jax(jax.tree.map(np.asarray, jparams), _tcfg(cfg),
                            device="cpu")

    def as_dict(node):
        return {k: as_dict(v) if hasattr(v, "items") else v.detach()
                for k, v in node.items()}
    return as_dict(model.params)


_SETUPS = {}


def _optimizer(m, dtype):
    if dtype == "float64":
        return m.sgd(m.constant(1e-2), momentum=0.9)
    return m.adamw(m.warmup_cosine(1e-3, 1, 10), weight_decay=0.1)


def train_setup(arch, dtype):
    """(JAX cfg, port cfg, JAX stacked params, port stacked params, JAX
    batch, port batch, the JAX optimizer, its jitted per-node
    value_and_grad and update-and-apply), once per worker."""
    key = (arch, dtype)
    if key not in _SETUPS:
        cfg = rcfg.get_config(arch).smoke()
        if dtype == "float64":
            cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        params = rinit(jax.random.PRNGKey(0), cfg)
        tparams = tsteps.replicate_for_nodes(_torch_params(params, cfg),
                                             N_NODES)
        params = rsteps.replicate_for_nodes(params, N_NODES)
        if cfg.modality == "vlm":        # 16 text tokens after the patches
            batch = rtrain.make_batch(cfg, jax.random.PRNGKey(1), N_NODES, 2,
                                      cfg.vis_tokens + 16)
        else:
            toks = jax.random.randint(jax.random.PRNGKey(1),
                                      (N_NODES, 2, 16), 0, cfg.vocab_size,
                                      dtype=jnp.int32)
            batch = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=-1)}
        tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        opt = _optimizer(ropt, dtype)
        vg = jax.jit(jax.vmap(jax.value_and_grad(
            lambda p, b: rsteps.loss_fn(p, b, cfg))))

        @jax.jit
        def update(grads, state, params):
            updates, state = opt.update(grads, state, params)
            return ropt.apply_updates(params, updates), state
        _SETUPS[key] = (cfg, _tcfg(cfg), params, tparams, batch, tbatch, opt,
                       vg, update)
    return _SETUPS[key]


def _reference_steps(setup, agg, steps=STEPS):
    """The JAX package's fused step body, ``steps`` times: [(losses,
    grads before aggregation, params after the step)]."""
    _, _, params, _, batch, _, opt, vg, update = setup
    pre = jax.jit(lambda t: ragg.aggregate_gradients(t, agg))
    post = jax.jit(lambda t: ragg.aggregate_params(t, agg))
    state, out = opt.init(params), []
    for _ in range(steps):
        losses, raw = vg(params, batch)
        params, state = update(pre(raw), state, params)
        params = post(params)
        out.append((losses, raw, params))
    return out


def _port_steps(make, cfg, opt, agg, params, batch, steps=STEPS):
    state = tsteps.TrainState(params, opt.init(params),
                              torch.zeros((), dtype=torch.int32))
    step, out = make(cfg, opt, agg, N_NODES), []
    for _ in range(steps):
        state, metrics = step(state, batch)
        out.append((metrics["loss_per_node"], state.params))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(metrics["loss_per_node"].mean()))
    assert int(state.step) == steps
    return out


def _close_f64_params(got, want, strategy):
    """PARAM_F64 on the float64 leaves; mamba2's A_log, dt_bias and D are
    float32 in every configuration, and are held within two float32
    ulps besides; ``quantized``'s within two bfloat16 ulps of the leaf's
    largest entry besides."""
    dtypes = {p: x.dtype for p, x in tree_leaves_with_path(got)}
    got, want = leaf_paths(got), leaf_paths(want)
    for path, w in want.items():
        rtol = 2.0 ** -22 if dtypes[path] == torch.float32 else 0.0
        atol = PARAM_F64["atol"]
        if strategy == "quantized":
            atol += 2.0 ** -6 * float(np.nanmax(np.abs(w), initial=0.0))
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol,
                                   err_msg=path)


def check_train_step(arch, strategy, dtype):
    """Three steps of the port's fused step (and, at float32, of the
    unfused one) against the JAX package's; float32 also the first
    step's per-node gradients."""
    setup = train_setup(arch, dtype)
    tc, tparams, tbatch = setup[1], setup[3], setup[5]
    ja, ta = agg_pair(strategy=strategy, local_patterns=("embed",))
    want = _reference_steps(setup, ja)
    makes = [tsteps.make_train_step_fused]
    if dtype == "float32":
        losses, grads = tsteps.node_value_and_grad(tparams, tbatch, tc,
                                                   N_NODES)
        np.testing.assert_allclose(as_np(losses), as_np(want[0][0]), **LOSS_F32)
        close_trees(grads, want[0][1], GRAD_F32)
        makes.append(tsteps.make_train_step)
    for make in makes:
        got = _port_steps(make, tc, _optimizer(topt, dtype), ta, tparams,
                          tbatch)
        for i, ((gl, gp), (wl, wg, wp)) in enumerate(zip(got, want)):
            if dtype == "float64":
                np.testing.assert_allclose(as_np(gl), as_np(wl), **LOSS_F64)
            else:
                tol = (LOSS_F32_TOPK_LATER if strategy == "topk" and i
                       else LOSS_F32)
                np.testing.assert_allclose(as_np(gl), as_np(wl), **tol)
            if not all(np.isfinite(x).all() for x in leaf_paths(wg).values()):
                # the reference's ssd_chunked gradient hit its masked-exp
                # overflow (0·inf); the port's is finite, and the two
                # trajectories part here
                assert arch == "mamba2-130m"
                assert all(np.isfinite(x).all()
                           for x in leaf_paths(gp).values())
                break
            if dtype == "float64":
                _close_f64_params(gp, wp, strategy)


def check_fused_step(arch, steps=2):
    """The port's fused step as ``launch.train`` runs it (diffusion, AdamW
    on a warmup-cosine schedule, the embedding and LM head local) against
    the JAX package's own jitted ``make_train_step_fused``: the first
    step's per-node losses and gradients before aggregation (GRAD_F32),
    then the per-node losses of ``steps`` steps (LOSS_F32), the MoE aux
    loss inside every one."""
    setup = train_setup(arch, "float32")
    cfg, tc, params, tparams, batch, tbatch, opt, vg = setup[:8]
    losses, grads = tsteps.node_value_and_grad(tparams, tbatch, tc, N_NODES)
    want_losses, want_grads = vg(params, batch)
    np.testing.assert_allclose(as_np(losses), as_np(want_losses), **LOSS_F32)
    close_trees(grads, want_grads, GRAD_F32)
    ja, ta = agg_pair(strategy="diffusion", local_patterns=LOCAL)
    step = jax.jit(rsteps.make_train_step_fused(cfg, opt, ja, N_NODES))
    state = rsteps.TrainState(params, opt.init(params),
                              jnp.zeros((), jnp.int32))
    got = _port_steps(tsteps.make_train_step_fused, tc,
                      _optimizer(topt, "float32"), ta, tparams, tbatch,
                      steps=steps)
    for gl, _ in got:
        state, metrics = step(state, batch)
        np.testing.assert_allclose(as_np(gl), as_np(metrics["loss_per_node"]),
                                   **LOSS_F32)


def check_reference_step(arch):
    """The JAX package's own jitted ``make_train_step_fused`` (diffusion,
    AdamW on a warmup-cosine schedule, the embedding and LM head local, as
    ``launch.train`` runs it) against the port's and against the composed
    reference, float32 losses of every step."""
    setup = train_setup(arch, "float32")
    cfg, tc, params, tparams, batch, tbatch, opt = setup[:7]
    ja, ta = agg_pair(strategy="diffusion", local_patterns=LOCAL)
    step = jax.jit(rsteps.make_train_step_fused(cfg, opt, ja, N_NODES))
    state = rsteps.TrainState(params, opt.init(params),
                              jnp.zeros((), jnp.int32))
    got = _port_steps(tsteps.make_train_step_fused, tc,
                      _optimizer(topt, "float32"), ta, tparams, tbatch)
    composed = _reference_steps(setup, ja)
    for (gl, _), (cl, _, _) in zip(got, composed):
        state, metrics = step(state, batch)
        np.testing.assert_allclose(as_np(gl), as_np(metrics["loss_per_node"]),
                                   **LOSS_F32)
        np.testing.assert_allclose(as_np(cl), as_np(metrics["loss_per_node"]),
                                   **LOSS_F32)
