"""The port's language models against the JAX package's, on the CPU.

Every module of ``repro_torch.models`` takes the JAX package's weights,
carried across by ``params_from_jax``, and the same inputs (numpy), and
must match ``repro.models`` within rtol = atol = 1e-5 at float32: the
layers, the three attention cores (−1 cache slots and sliding windows
included), ``ssd_chunked`` / ``ssd_step``, the blocks, and ``forward``
(its MoE aux loss included) and ``decode_step`` of all ten presets
(smoke variants; the vlm's forward with its patch embeddings).
Teacher-forced decode equals the full forward within 2e-3, the
tolerance of tests/test_arch_smoke.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as rcfg  # noqa: E402
import repro.models.attention as rattn  # noqa: E402
import repro.models.blocks as rblk  # noqa: E402
import repro.models.layers as rlay  # noqa: E402
import repro.models.ssm as rssm  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblk  # noqa: E402
from repro_torch.models import layers as tlay  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PREFILL_DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
# every preset: dense GQA (qk-norm, MQA, parallel blocks), the Mamba2
# stack, the audio token stream, MoE (softmax router with a dense
# residual; sigmoid router with a shared expert, MLA and leading dense
# layers), the zamba hybrid, the vlm frontend
PORTED = ("qwen3-1.7b", "mamba2-130m", "granite-20b", "command-r-35b",
          "phi4-mini-3.8b", "musicgen-medium", "arctic-480b",
          "deepseek-v3-671b", "zamba2-7b", "llava-next-mistral-7b")
SEQ = 24


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    """allclose; ``atol=None`` means rtol times the largest |want|."""
    want = np.asarray(want, np.float32)
    if tol["atol"] is None:
        tol = dict(tol, atol=tol["rtol"] * float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, **tol)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


_MODELS = {}


def _model(name, cfg=None):
    """(cfg, JAX params, the port's model on those weights), once per
    configuration."""
    cfg = cfg or rcfg.get_config(name).smoke()
    if cfg not in _MODELS:
        params = rtfm.init_params(jax.random.PRNGKey(0), cfg)
        _MODELS[cfg] = (cfg, params, params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return _MODELS[cfg]


def _tokens(cfg, seed, batch=2, seq=SEQ):
    return _rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32)


# ---------------------------------------------------------------- configs

def test_registry_matches_the_jax_presets():
    assert tuple(tcfg.REGISTRY) == tuple(rcfg.REGISTRY)
    for name, cfg in rcfg.REGISTRY.items():
        assert dataclasses.asdict(tcfg.get_config(name)) == \
            dataclasses.asdict(cfg)
        assert dataclasses.asdict(tcfg.get_config(name).smoke()) == \
            dataclasses.asdict(cfg.smoke())
        assert tcfg.get_config(name).n_params() == cfg.n_params()
    with pytest.raises(KeyError):
        tcfg.get_config("gpt-2")


@pytest.mark.parametrize("name", tuple(rcfg.REGISTRY))
def test_full_width_parameter_count(name):
    """init_params on the meta device at full width: the analytic count
    (≈ 1.72 B for qwen3-1.7b, 0.13 B for mamba2-130m, 691 B for
    deepseek-v3-671b)."""
    cfg = tcfg.get_config(name)
    params = ttfm.init_params(cfg, device="meta")
    assert ttfm.count_params(params) == cfg.n_params()


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    rng = _rng(0)
    x = _f32(rng, 2, 5, 3, 16)
    w, scale = _f32(rng, 16, 12), _f32(rng, 16)
    xj = jnp.asarray(x).astype(dtype)
    xt = _t(x).to(getattr(torch, dtype))
    # bf16: a few ulps (2^-7 relative spacing) of the largest output,
    # since the two frameworks round at different places and a value that
    # cancels keeps its terms' rounding
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=None)
    p_lin = {"w": w, "b": _f32(rng, 12)}
    _close(_np(tlay.linear({k: _t(v) for k, v in p_lin.items()}, xt)),
           rlay.linear(p_lin, xj), tol)
    _close(_np(tlay.rms_norm({"scale": _t(scale)}, xt, 1e-5)),
           rlay.rms_norm({"scale": scale}, xj, 1e-5), tol)
    p_ffn = {k: {"w": _f32(rng, *s)} for k, s in
             (("gate", (16, 8)), ("up", (16, 8)), ("down", (8, 16)))}
    _close(_np(tlay.swiglu({k: {"w": _t(v["w"])} for k, v in p_ffn.items()},
                           xt)), rlay.swiglu(p_ffn, xj), tol)
    pos = _rng(1).integers(0, 4096, (2, 5))
    _close(_np(tlay.apply_rope(xt, _t(pos), 1e6)),
           rlay.apply_rope(xj, jnp.asarray(pos, jnp.int32), 1e6), tol)
    table = _f32(rng, 50, 16)
    tok = _rng(2).integers(0, 50, (2, 5))
    _close(_np(tlay.embed({"table": _t(table)}, _t(tok))),
           rlay.embed({"table": table}, jnp.asarray(tok)))
    _close(_np(tlay.unembed({"table": _t(table)}, xt[:, :, 0])),
           rlay.unembed({"table": table}, xj[:, :, 0]), tol)


# ---------------------------------------------------------------- attention

def _attn_inputs(seed, Sq, Skv, H=4, Hkv=2, D=16, empty=0):
    rng = _rng(seed)
    q, k, v = (_f32(rng, 2, Sq, H, D), _f32(rng, 2, Skv, Hkv, D),
               _f32(rng, 2, Skv, Hkv, D))
    q_pos = np.tile(np.arange(Skv - Sq, Skv), (2, 1))
    k_pos = np.tile(np.arange(Skv), (2, 1))
    if empty:                             # a ring buffer not yet full
        k_pos[:, -empty:] = -1
        q_pos = q_pos - empty
    return q, k, v, q_pos, k_pos


@pytest.mark.parametrize("core", ["attention_core", "chunked_attention",
                                  "attention_dispatch"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("Sq,Skv,empty", [(24, 24, 0), (1, 40, 7),
                                          (8, 37, 3)])
def test_attention_cores_match_jax(core, window, Sq, Skv, empty):
    q, k, v, q_pos, k_pos = _attn_inputs(3, Sq, Skv, empty=empty)
    kw = dict(window=window)
    if core == "chunked_attention":
        kw["chunk"] = 16                  # ragged: 37 and 40 keys
    got = getattr(tattn, core)(*map(_t, (q, k, v, q_pos, k_pos)), **kw)
    want = getattr(rattn, core)(*map(jnp.asarray, (q, k, v)),
                                jnp.asarray(q_pos, jnp.int32),
                                jnp.asarray(k_pos, jnp.int32), **kw)
    _close(_np(got), want)


def test_chunked_attention_threshold():
    """attention_dispatch takes the chunked path above CHUNK_THRESHOLD
    keys, as the JAX package does."""
    assert tattn.CHUNK_THRESHOLD == rattn.CHUNK_THRESHOLD == 2048
    q, k, v, q_pos, k_pos = _attn_inputs(4, 2, 2049, H=2, Hkv=1, D=8)
    got = tattn.attention_dispatch(*map(_t, (q, k, v, q_pos, k_pos)))
    _close(_np(got), rattn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(q_pos, jnp.int32),
        jnp.asarray(k_pos, jnp.int32)))


# ---------------------------------------------------------------- SSD

def _ssd_inputs(seed, B=2, S=40, H=3, P=8, N=16):
    rng = _rng(seed)
    x = _f32(rng, B, S, H, P)
    dt = (np.log1p(np.exp(_f32(rng, B, S, H))) * 0.1).astype(np.float32)
    A = (-np.exp(_f32(rng, H) * 0.3)).astype(np.float32)
    return x, dt, A, _f32(rng, B, S, N), _f32(rng, B, S, N), \
        np.full((H,), 0.5, np.float32)


@pytest.mark.parametrize("chunk,with_h0", [(16, False), (8, True),
                                           (64, False)])
def test_ssd_chunked_matches_jax(chunk, with_h0):
    x, dt, A, Bm, Cm, D = _ssd_inputs(5)
    h0 = _f32(_rng(6), 2, 3, 8, 16) if with_h0 else None
    y, h = tssm.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, D)), chunk,
                            h0=None if h0 is None else _t(h0))
    y_ref, h_ref = rssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)),
                                    chunk, h0=h0)
    _close(_np(y), y_ref)
    _close(_np(h), h_ref)


def test_ssd_step_matches_jax():
    x, dt, A, Bm, Cm, D = _ssd_inputs(7, S=1)
    h = _f32(_rng(8), 2, 3, 8, 16)
    got = tssm.ssd_step(_t(h), _t(x[:, 0]), _t(dt[:, 0]), _t(A), _t(Bm[:, 0]),
                        _t(Cm[:, 0]), _t(D))
    want = rssm.ssd_step(jnp.asarray(h), x[:, 0], dt[:, 0], A, Bm[:, 0],
                         Cm[:, 0], D)
    for g, w in zip(got, want):
        _close(_np(g), w)


# ---------------------------------------------------------------- blocks

def _layer0(jax_params):
    return jax.tree.map(lambda a: np.asarray(a)[0], jax_params["seg0"])


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-130m",
                                  "command-r-35b"])
def test_block_forward_and_decode_match_jax(name):
    cfg, params, model = _model(name)
    kind = rtfm.build_plan(cfg)[0][1]
    p_np = _layer0(params)
    p_t = ttfm._index(model.params["seg0"], 0)
    x = _f32(_rng(9), 2, 12, cfg.d_model)
    pos = np.tile(np.arange(12), (2, 1))
    got, aux = tblk.block_forward(p_t, _t(x), cfg, kind, _t(pos))
    want, _ = rblk.block_forward(p_np, jnp.asarray(x), cfg, kind,
                                 jnp.asarray(pos, jnp.int32))
    _close(_np(got), want)
    assert float(aux) == 0.0
    c_t = tblk.block_init_cache(cfg, kind, 2, 12, torch.float32, "cpu")
    c_j = rblk.block_init_cache(cfg, kind, 2, 12, jnp.float32)
    step = jax.jit(lambda p, x, c, t: rblk.block_decode(p, x, cfg, kind, c,
                                                        t))
    for t in range(3):
        got, c_t = tblk.block_decode(p_t, _t(x[:, t:t + 1]), cfg, kind, c_t,
                                     t)
        want, c_j = step(p_np, jnp.asarray(x[:, t:t + 1]), c_j, jnp.int32(t))
        _close(_np(got), want)
    for g, w in zip(c_t, c_j):
        _close(_np(g), w)


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("name", PORTED)
def test_forward_matches_jax(name):
    cfg, params, model = _model(name)
    toks = _tokens(cfg, 10)
    batch = {"tokens": toks}
    if cfg.modality == "vlm":             # the patch embeddings go first
        batch["vis_embed"] = _f32(_rng(14), 2, cfg.vis_tokens,
                                  cfg.d_model) * 0.02
    logits, aux = ttfm.forward(model.params,
                               {k: _t(v) for k, v in batch.items()}, cfg)
    want, want_aux = rtfm.forward(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    S = SEQ + (cfg.vis_tokens if cfg.modality == "vlm" else 0)
    assert logits.shape == (2, S, cfg.vocab_size)
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    _close(_np(logits), want)
    _close(_np(aux), want_aux)
    assert (float(aux) > 0) == bool(cfg.n_experts)


def _decode_both(cfg, params, model, toks, capacity):
    st_j = rtfm.init_cache(cfg, batch=toks.shape[0], capacity=capacity)
    st_t = model.init_cache(toks.shape[0], capacity)
    step = jax.jit(lambda p, s, t: rtfm.decode_step(p, s, t, cfg))
    outs = []
    for i in range(toks.shape[1]):
        lj, st_j = step(params, st_j, jnp.asarray(toks[:, i:i + 1]))
        lt, st_t = ttfm.decode_step(model.params, st_t, _t(toks[:, i:i + 1]),
                                    cfg)
        outs.append((_np(lt), np.asarray(lj)))
    assert st_t.pos == int(st_j.pos) == toks.shape[1]
    return outs


@pytest.mark.parametrize("name", PORTED)
def test_decode_step_matches_jax(name):
    cfg, params, model = _model(name)
    for got, want in _decode_both(cfg, params, model, _tokens(cfg, 11)[:, :8],
                                  capacity=8):
        assert got.shape == (2, 1, cfg.vocab_size)
        _close(got, want)


def test_sliding_window_ring_buffer_matches_jax():
    """A windowed GQA model decoding past its window: the cache is a
    ring buffer of window slots, overwritten in place."""
    cfg = dataclasses.replace(rcfg.get_config("qwen3-1.7b").smoke(),
                              sliding_window=6)
    cfg, params, model = _model(None, cfg)
    toks = _tokens(cfg, 12)
    want, _ = rtfm.forward(params, {"tokens": jnp.asarray(toks)}, cfg)
    _close(_np(model(_t(toks))), want)
    for got, want in _decode_both(cfg, params, model, toks[:, :10],
                                  capacity=6):
        _close(got, want)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-130m", "zamba2-7b",
                                  "deepseek-v3-671b"])
def test_prefill_matches_teacher_forced_decode(name):
    """tests/test_arch_smoke.py's check on the port alone: decode steps
    over the tokens ≡ the full-sequence forward."""
    cfg, _, model = _model(name)
    toks = _t(_tokens(cfg, 13, batch=1, seq=8))
    full = model(toks)
    state = model.init_cache(1, 8)
    dec = []
    for i in range(8):
        lg, state = model.decode_step(state, toks[:, i:i + 1])
        dec.append(lg[:, 0])
    _close(_np(torch.stack(dec, dim=1)), _np(full), PREFILL_DECODE_TOL)


# ---------------------------------------------------------------- weights

def test_params_from_jax_checks_the_tree():
    cfg, params, _ = _model("qwen3-1.7b")
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, seg0=dict(tree["seg0"], norm1={
        "scale": tree["seg0"]["norm1"]["scale"][0]}))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_jax({k: v for k, v in tree.items() if k != "final_norm"},
                        cfg, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(dict(tree, extra={"w": np.zeros(3)}), cfg,
                        device="cpu")


def test_init_params_draws_from_its_seed():
    cfg = tcfg.get_config("mamba2-130m").smoke()
    a = ttfm.init_params(cfg, seed=3, device="cpu")
    b = ttfm.init_params(cfg, seed=3, device="cpu")
    c = ttfm.init_params(cfg, seed=4, device="cpu")
    for (pa, ta), (_, tb), (_, tc) in zip(ttfm.leaves(a), ttfm.leaves(b),
                                          ttfm.leaves(c)):
        assert torch.equal(ta, tb), pa
    w = ttfm.leaves(a)[0][1]
    assert not torch.equal(w, ttfm.leaves(c)[0][1])
    assert float(w.abs().max()) <= 2.0 * 0.02 * 5   # ~N(0, 0.02) table
    lin = a["seg0"]["mixer"]["in_proj"]["w"]
    assert float(lin.abs().max()) <= 2.0 * cfg.d_model ** -0.5  # truncated
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttfm.init_params(cfg)
