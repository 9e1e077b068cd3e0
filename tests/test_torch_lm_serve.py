"""The port's LM serving path against the JAX package's, on the CPU.

* ``make_prefill_step`` (last-position logits of a full forward; the
  vlm's batch carries its patch embeddings) and ``make_serve_step`` (one
  decode token against the cache, token-only) against
  ``repro.launch.steps``' on the same weights (carried across by
  ``params_from_jax``) and tokens: rtol = atol = 1e-5 at float32.
* The ``generate`` helper's greedy tokens equal those of a JAX
  ``decode_step`` loop that prefills the same prompt by teacher-forced
  decode and takes the argmax, as ``repro.launch.serve.generate`` does;
  its kept prefill logits equal the JAX loop's.
* ``serving_params`` casts the linear weights and the MoE expert stacks
  in place, not the router, and changes no logit.
* ``generate()`` runs on the card unless given ``device=``, and raises
  without one; seeded runs repeat; ``main`` runs on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("qwen3-1.7b", "mamba2-130m", "arctic-480b", "deepseek-v3-671b",
         "zamba2-7b", "llava-next-mistral-7b", "granite-20b",
         "command-r-35b", "phi4-mini-3.8b", "musicgen-medium")

_MODELS = {}


def _model(name):
    if name not in _MODELS:
        cfg = rcfg.get_config(name).smoke()
        params = rtfm.init_params(jax.random.PRNGKey(1), cfg)
        _MODELS[name] = (cfg, params, params_from_jax(
            jax.tree.map(np.asarray, params), cfg, device="cpu"))
    return _MODELS[name]


def _tokens(cfg, seed, batch=2, seq=16):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_step_matches_jax(name):
    cfg, params, model = _model(name)
    batch = {"tokens": _tokens(cfg, 0)}
    if cfg.modality == "vlm":
        batch["vis_embed"] = (np.random.default_rng(3).standard_normal(
            (2, cfg.vis_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    got = steps.make_prefill_step(cfg)(
        model.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = rsteps.make_prefill_step(cfg)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    assert got.shape == (2, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_step_matches_jax(name):
    cfg, params, model = _model(name)
    toks = _tokens(cfg, 1, seq=6)
    serve_t = steps.make_serve_step(cfg)
    serve_j = jax.jit(rsteps.make_serve_step(cfg))
    st_t = model.init_cache(2, 6)
    st_j = rtfm.init_cache(cfg, batch=2, capacity=6)
    for i in range(6):
        lt, st_t = serve_t(model.params, st_t, torch.from_numpy(
            toks[:, i:i + 1]))
        lj, st_j = serve_j(params, st_j, jnp.asarray(toks[:, i:i + 1]))
        _close(lt, lj)
    assert st_t.pos == 6


def _jax_greedy(cfg, params, prompt, gen):
    """The JAX package's serve loop: teacher-forced prefill, argmax."""
    step = jax.jit(lambda p, s, t: rtfm.decode_step(p, s, t, cfg))
    state = rtfm.init_cache(cfg, batch=prompt.shape[0],
                            capacity=prompt.shape[1] + gen)
    kept = []
    for i in range(prompt.shape[1]):
        logits, state = step(params, state, jnp.asarray(prompt[:, i:i + 1]))
        kept.append(logits[:, 0])
    out = []
    for _ in range(gen):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok[:, 0])
        logits, state = step(params, state, tok)
    return np.stack(out, axis=1), jnp.stack(kept, axis=1)


@pytest.mark.parametrize("name", ARCHS)
def test_generate_greedy_tokens_equal_jax_decode_loop(name):
    cfg, params, model = _model(name)
    prompt = _tokens(cfg, 2, seq=12)
    tokens, stats = serve.generate_tokens(
        model, torch.from_numpy(prompt).long(), 8, keep_prefill_logits=True)
    want_tokens, want_logits = _jax_greedy(cfg, params, prompt, 8)
    assert tokens.shape == (2, 8)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    _close(stats["prefill_logits"], want_logits)
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0


def test_generate_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate("mamba2-130m", gen=2)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_on_the_cpu_repeats_from_its_seed(temperature):
    kw = dict(batch=2, prompt_len=5, gen=4, temperature=temperature,
              device="cpu")
    a, _ = serve.generate("qwen3-1.7b", seed=3, **kw)
    b, _ = serve.generate("qwen3-1.7b", seed=3, **kw)
    assert a.shape == (2, 4) and a.dtype == torch.long
    assert torch.equal(a, b)
    assert int(a.max()) < rcfg.get_config("qwen3-1.7b").smoke().vocab_size


@pytest.mark.parametrize("name", ARCHS[1:])
def test_serve_main_on_the_cpu(capsys, name):
    serve.main(["--arch", name, "--device", "cpu", "--gen", "3",
                "--prompt-len", "4"])
    out = capsys.readouterr().out
    assert "generated token ids (first row):" in out and "tok_per_s" in out


def test_serving_params_cast_the_expert_stacks_once():
    """The serving copy casts every linear weight and the MoE expert
    stacks to the activation dtype and keeps the router (f32 by design),
    the norms and the embedding, in place: each leaf is replaced in the
    tree itself.  The model's function does not change: linear and
    moe_forward cast at use anyway."""
    from repro_torch.models import transformer as ttfm
    cfg, _, model = _model("deepseek-v3-671b")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    own = _as_dict(model.params)
    assert ttfm.serving_params(own, cfg16) is own
    tree = dict(ttfm.leaves(own))
    moe = "seg1/ffn"
    for part in ("gate", "up", "down"):
        assert tree[f"{moe}/experts/{part}"].dtype == torch.bfloat16
    assert tree[f"{moe}/router"].dtype == torch.float32
    assert tree[f"{moe}/shared/up/w"].dtype == torch.bfloat16
    assert tree["seg0/mixer/wuk/w"].dtype == torch.bfloat16
    assert tree["seg0/mixer/kv_norm/scale"].dtype == torch.float32
    assert tree["embed/table"].dtype == torch.float32
    assert model.params["seg1"]["ffn"]["experts"]["up"].dtype == \
        torch.float32
    toks = torch.from_numpy(_tokens(cfg, 4, seq=8)).long()
    a = ttfm.forward(model.params, {"tokens": toks}, cfg16)
    b = ttfm.forward(own, {"tokens": toks}, cfg16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _as_dict(node):
    return {k: _as_dict(v) if hasattr(v, "items") else v.detach()
            for k, v in node.items()}
