"""The port's MoE FFN, MLA attention and zamba layout against the JAX
package's, on the CPU.

Inputs are drawn from a seed with numpy; weights are the JAX package's
(``init_moe`` / ``init_mla`` / ``init_params``) carried across as numpy.
Tolerances: the port against the JAX package at float32, rtol = atol =
1e-5 (``tests/test_torch_models.py``'s); the sort-based dispatch against
its dense oracle rtol = atol = 2e-4 and the absorbed-matmul decode
against the full-sequence forward 2e-4 (the JAX package's own, in
``tests/test_model_properties.py`` and ``tests/test_arch_smoke.py``:
both sides sum in other orders); the sigmoid router's gates sum to 1
within rtol 1e-6.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as rcfg  # noqa: E402
import repro.models.attention as rattn  # noqa: E402
import repro.models.moe as rmoe  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_TOL = dict(rtol=2e-4, atol=2e-4)


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    """A JAX parameter dict as the port's dict of CPU tensors."""
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _moe_cfg(arch="arctic-480b", **kw):
    return dataclasses.replace(rcfg.get_config(arch).smoke(), **kw)


def _moe_params(cfg, seed=0):
    p = rmoe.init_moe(jax.random.PRNGKey(seed), cfg)
    return p, _tree_t(p)


# ---------------------------------------------------------------- MoE

@pytest.mark.parametrize("arch,capacity_factor", [
    ("arctic-480b", 1.25), ("deepseek-v3-671b", 1.25),
    ("arctic-480b", 0.25), ("deepseek-v3-671b", 0.25)])
def test_moe_forward_matches_jax(arch, capacity_factor):
    """Softmax router with a dense residual (arctic) and sigmoid_norm
    with a shared expert (deepseek); at capacity factor 0.25 most
    assignments are dropped, and the same ones on both sides."""
    cfg = _moe_cfg(arch, capacity_factor=capacity_factor)
    p_j, p_t = _moe_params(cfg)
    x = _x(1, 2, 24, cfg.d_model)
    y, aux = tmoe.moe_forward(p_t, _t(x), cfg)
    y_j, aux_j = rmoe.moe_forward(p_j, jnp.asarray(x), cfg)
    np.testing.assert_allclose(_np(y), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), **TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert tmoe.capacity(48, cfg) == rmoe.capacity(48, cfg)


def test_moe_dispatch_matches_its_dense_oracle():
    """With capacity ample enough that nothing drops, the sort-based
    dispatch equals every expert evaluated densely."""
    for arch in ("arctic-480b", "deepseek-v3-671b"):
        cfg = _moe_cfg(arch, capacity_factor=8.0)
        _, p = _moe_params(cfg)
        x = _t(_x(2, 2, 8, cfg.d_model, scale=0.3))
        y, aux = tmoe.moe_forward(p, x, cfg)
        np.testing.assert_allclose(
            _np(y), _np(tmoe.moe_forward_dense_fallback(p, x, cfg)),
            **ORACLE_TOL)
        assert float(aux) > 0


def test_moe_capacity_drops_tokens_gracefully():
    """At a capacity factor of ~0 (C = 8, its floor, for 64 assignments
    over 4 experts) the output stays finite, equals the JAX package's,
    and parts from the undropped dispatch."""
    cfg = _moe_cfg(capacity_factor=1e-6)
    p_j, p_t = _moe_params(cfg)
    x = _x(3, 2, 16, cfg.d_model)
    y, _ = tmoe.moe_forward(p_t, _t(x), cfg)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(
        _np(y), np.asarray(rmoe.moe_forward(p_j, jnp.asarray(x), cfg)[0]),
        **TOL)
    full, _ = tmoe.moe_forward(
        p_t, _t(x), dataclasses.replace(cfg, capacity_factor=8.0))
    assert not torch.allclose(y, full)


def test_moe_sigmoid_router_gates_normalized():
    cfg = _moe_cfg(router_score="sigmoid_norm")
    _, p = _moe_params(cfg)
    gates, idx, _ = tmoe._route(_t(_x(4, 8, cfg.d_model)), p, cfg)
    assert gates.shape == idx.shape == (8, cfg.top_k)
    np.testing.assert_allclose(_np(gates.sum(-1)), 1.0, rtol=1e-6)


def test_moe_gradients_reach_router_and_every_expert():
    """The gradient of sum(y²) + aux through the dispatch, against the
    JAX package's jax.grad: the router and every expert's stacks get
    one, nonzero."""
    cfg = _moe_cfg(capacity_factor=2.0)
    p_j, p_t = _moe_params(cfg)
    x = _x(5, 2, 16, cfg.d_model)
    leaves = {"router": p_t["router"], **p_t["experts"]}
    for t in leaves.values():
        t.requires_grad_()
    y, aux = tmoe.moe_forward(p_t, _t(x), cfg)
    got = dict(zip(leaves, torch.autograd.grad(
        torch.sum(y ** 2) + aux, list(leaves.values()))))

    def loss(p):
        y, aux = rmoe.moe_forward(p, jnp.asarray(x), cfg)
        return jnp.sum(y ** 2) + aux
    g = jax.grad(loss)(p_j)
    want = {"router": g["router"], **g["experts"]}
    for name, gr in got.items():
        np.testing.assert_allclose(_np(gr), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        per_expert = gr.abs().flatten(1).sum(1) if name != "router" \
            else gr.abs().sum(0)
        assert bool((per_expert > 0).all()), name


# ---------------------------------------------------------------- MLA

def _mla():
    cfg = rcfg.get_config("deepseek-v3-671b").smoke()
    p = rattn.init_mla(jax.random.PRNGKey(6), cfg)
    return cfg, p, _tree_t(p)


def test_mla_forward_and_decode_match_jax():
    """The full-sequence MLA (V padded to the query-key head dim, scale
    (dn + dr)^-1/2) and the absorbed-matmul decode, step by step into a
    ring buffer, against the JAX package's; the decode's cache too."""
    cfg, p_j, p_t = _mla()
    B, S = 2, 10
    x = _x(7, B, S, cfg.d_model)
    pos = np.tile(np.arange(S), (B, 1))
    y = tattn.mla_forward(p_t, _t(x), cfg, _t(pos))
    y_j = rattn.mla_forward(p_j, jnp.asarray(x), cfg,
                            jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(_np(y), np.asarray(y_j), **TOL)
    c_t = tattn.mla_init_cache(cfg, B, 6, torch.float32, "cpu")
    c_j = rattn.mla_init_cache(cfg, B, 6, jnp.float32)
    step = jax.jit(lambda x, c, t: rattn.mla_decode(p_j, x, cfg, c, t))
    for t in range(S):                    # past the 6 slots: a ring
        got, c_t = tattn.mla_decode(p_t, _t(x[:, t:t + 1]), cfg, c_t, t)
        want, c_j = step(jnp.asarray(x[:, t:t + 1]), c_j, jnp.int32(t))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for g, w in zip(c_t, c_j):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_mla_absorbed_decode_equals_the_forward():
    """Decode against the latent cache ≡ the per-head expansion of the
    full-sequence forward, position by position."""
    cfg, _, p = _mla()
    B, S = 2, 12
    x = _t(_x(8, B, S, cfg.d_model))
    full = tattn.mla_forward(p, x, cfg, torch.arange(S).expand(B, S))
    cache = tattn.mla_init_cache(cfg, B, S, torch.float32, "cpu")
    for t in range(S):
        got, cache = tattn.mla_decode(p, x[:, t:t + 1], cfg, cache, t)
        np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, t]),
                                   **ORACLE_TOL)


# ---------------------------------------------------------------- zamba

def test_zamba_layout_and_shared_caches():
    """zamba2's smoke plan (4 layers, period 2): one zamba segment of 2
    groups, its leaves stacked (n_groups, period, ...), one shared
    attention block at the top level; the decode state holds one KV
    cache a group under the one shared weight set.  Full width: 13
    groups of 6 and a trailing scan of 3."""
    cfg = rcfg.get_config("zamba2-7b").smoke()
    assert ttfm.build_plan(cfg) == rtfm.build_plan(cfg) == [("zamba", 2, 2)]
    full = rcfg.get_config("zamba2-7b")
    assert ttfm.build_plan(full) == rtfm.build_plan(full) == [
        ("zamba", 13, 6), ("scan", ("ssm", "none"), 3)]
    params = ttfm.init_params(cfg, device="cpu")
    assert set(params) == {"embed", "final_norm", "lm_head", "shared_attn",
                           "seg0"}
    for path, t in ttfm.leaves(params["seg0"]):
        assert tuple(t.shape[:2]) == (2, 2), path
    assert params["shared_attn"]["attn"]["wq"]["w"].shape == (
        cfg.d_model, cfg.n_heads * cfg.d_head)
    state = ttfm.init_cache(cfg, 3, 5, device="cpu")
    assert state.shared_caches.k.shape == (2, 3, 5, cfg.n_kv_heads,
                                           cfg.d_head)
    assert bool((state.shared_caches.positions == -1).all())
    assert state.caches[0].state.shape[:3] == (2, 2, 3)
    jstate = rtfm.init_cache(cfg, batch=3, capacity=5)
    for g, w in zip(state.shared_caches, jstate.shared_caches):
        assert tuple(g.shape) == tuple(w.shape)
    # one decode step writes slot 0 of every group's shared cache
    model = ttfm.LanguageModel(cfg, params)
    _, state = model.decode_step(state, torch.zeros((3, 1),
                                                    dtype=torch.long))
    assert bool((state.shared_caches.positions[:, :, 0] == 0).all())
    assert bool((state.shared_caches.k[:, :, 0] != 0).any(-1).all())


# ---------------------------------------------------------------- frontends

def test_frontend_stubs_match_jax_shapes():
    """The stub frontends draw from a torch.Generator (not the JAX
    package's keys): the same shapes, dtypes and ranges as
    ``repro.models.frontends``', N(0, 0.02²) patch embeddings, and the
    same refusal of a sequence no longer than the patch budget."""
    from repro.models import frontends as rfront
    from repro_torch.models import frontends as tfront
    cfg = rcfg.get_config("llava-next-mistral-7b").smoke()
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    got = tfront.vlm_batch_stub(g, 3, 40, cfg)
    want = rfront.vlm_batch_stub(key, 3, 40, cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["vis_embed"].dtype == getattr(torch, cfg.dtype)
    assert float(got["vis_embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert 0 <= int(got["tokens"].min()) and \
        int(got["tokens"].max()) < cfg.vocab_size
    emb = tfront.vision_embed_stub(g, 2, cfg, dtype="bfloat16")
    assert emb.dtype == torch.bfloat16 and emb.shape == (2, cfg.vis_tokens,
                                                          cfg.d_model)
    audio = rcfg.get_config("musicgen-medium").smoke()
    toks = tfront.audio_token_stub(g, 2, 9, audio)
    assert toks.shape == rfront.audio_token_stub(key, 2, 9, audio).shape
    assert int(toks.max()) < audio.vocab_size
    for mod, k in ((tfront, g), (rfront, key)):
        with pytest.raises(ValueError, match="vis_tokens"):
            mod.vlm_batch_stub(k, 1, cfg.vis_tokens, cfg)


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b",
                                  "zamba2-7b", "llava-next-mistral-7b"])
def test_params_from_jax_new_plans(arch):
    """Every leaf of the new plans — the router, the expert stacks,
    shared and dense, the MLA leaves, shared_attn and the zamba (n_groups,
    period) layout — is carried across as it is; a misshapen, missing or
    extra leaf raises."""
    cfg = rcfg.get_config(arch).smoke()
    tree = jax.tree.map(np.asarray,
                        rtfm.init_params(jax.random.PRNGKey(0), cfg))
    model = params_from_jax(tree, cfg, device="cpu")
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = dict(ttfm.leaves(_as_dict(model.params)))
    assert got.keys() == flat.keys()
    for path, want in flat.items():
        assert np.array_equal(_np(got[path]), want), path
    seg = tree["seg1"] if cfg.n_experts and "seg1" in tree else tree["seg0"]
    if cfg.n_experts:
        bad = _replace(tree, seg, "ffn", "experts", "gate",
                       lambda a: a[..., :-1])
        with pytest.raises(ValueError, match="experts/gate"):
            params_from_jax(bad, cfg, device="cpu")
    if cfg.attn_impl == "mla":
        bad = _replace(tree, seg, "mixer", "wuk", "w", lambda a: a.T)
        with pytest.raises(ValueError, match="wuk"):
            params_from_jax(bad, cfg, device="cpu")
    if cfg.block_pattern == "zamba":
        bad = _replace(tree, seg, "mixer", "A_log", None, lambda a: a[0])
        with pytest.raises(ValueError, match="A_log"):
            params_from_jax(bad, cfg, device="cpu")
        with pytest.raises(ValueError, match="missing"):
            params_from_jax({k: v for k, v in tree.items()
                             if k != "shared_attn"}, cfg, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(dict(tree, extra={"w": np.zeros(3)}), cfg,
                        device="cpu")


def _as_dict(node):
    return {k: _as_dict(v) if hasattr(v, "items") else v.detach()
            for k, v in node.items()}


def _replace(tree, seg, a, b, c, fn):
    """``tree`` with leaf seg/a/b[/c] replaced by ``fn`` of it."""
    name = next(k for k, v in tree.items() if v is seg)
    inner = dict(seg[a])
    if c is None:
        inner[b] = fn(inner[b])
    else:
        inner[b] = dict(inner[b], **{c: fn(inner[b][c])})
    return dict(tree, **{name: dict(seg, **{a: inner})})
