"""This slice's kernel ops and combine rules against the JAX package's,
on the same numpy-made inputs, on the CPU.

* ``ops.altgdmin_node_gradient`` (kernel ``node_task_grad_tiles`` on
  the card) against the reference's ``pallas-interpret`` and ``xla-ref``
  routes at f32 (rtol = atol = 1e-4, the reference's cross-backend
  tolerance; both compute in f32), and the dtype-preserving engine
  gradient at f64 against ``xla-ref`` (≤ 1e-10);
* ``ops.compress_topk`` against the reference's ``xla-ref`` route only
  (its ``pallas-interpret`` route fails on the installed jax): indices
  and rows equal at f32 and f64;
* ``ops.dequant`` equal to both reference routes;
* the compressed combine rules' stateful simulator mixers from
  ``init_state`` at f64 (≤ 1e-12 against ``xla-ref``), the lossless
  anchors bit for bit, the CHOCO relaxation, the stateless mixer's
  TypeError, and the stochastic int8 wire's invariants (its dither is
  the port's own counter-based draw, not ``jax.random``'s).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.engine import AltgdminEngine as RefEngine  # noqa: E402
from repro.distributed import get_rule as ref_get_rule  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.core.engine import AltgdminEngine  # noqa: E402
from repro_torch.distributed import consensus  # noqa: E402
from repro_torch.kernels import altgdmin_ls, compress, ops  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
F64 = dict(rtol=0, atol=1e-12)
# (L, tpn, n, d, r): d a multiple of the reference's 32-wide block or
# ragged (the reference pads it, the port does not); r ∈ {3, 4, 10}
CASES = [(3, 1, 20, 64, 3), (2, 3, 18, 97, 4), (2, 1, 30, 64, 10),
         (3, 2, 25, 97, 10)]


def _grad_instance(L, tpn, n, d, r, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((L, tpn, n, d))
    U = np.stack([np.linalg.qr(rng.standard_normal((d, r)))[0]
                  for _ in range(L)])
    B = rng.standard_normal((L, tpn, r))
    y = rng.standard_normal((L, tpn, n))
    return X, U, B, y


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float64).numpy(),
                               np.asarray(want, np.float64), **tol)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- gradient

@pytest.mark.parametrize("backend", ["pallas-interpret", "xla-ref"])
@pytest.mark.parametrize("case", CASES)
def test_node_gradient_matches_reference(case, backend):
    arrays = _grad_instance(*case)
    jargs = [jnp.asarray(a, jnp.float32) for a in arrays]
    targs = [torch.as_tensor(a, dtype=torch.float32) for a in arrays]
    X, U, B, y = jargs
    want = rops.altgdmin_node_gradient(X, U, B, y, blk_d=32, backend=backend)
    got = ops.altgdmin_node_gradient(*targs)
    assert got.dtype == torch.float32 and got.shape == (case[0], case[3],
                                                        case[4])
    _close(got, want, F32)


@pytest.mark.parametrize("case", CASES[:2])
def test_engine_gradient_f64_matches_xla_ref(case):
    """The torch-ref engine's grad_U keeps float64: ≤ 1e-10 against the
    reference's xla-ref engine; B comes in f64 as the min step gives
    it."""
    X, U, B, y = _grad_instance(*case, seed=1)
    jX, jU, jB, jy = (jnp.asarray(a, jnp.float64) for a in (X, U, B, y))
    tX, tU, tB, ty = (torch.as_tensor(a) for a in (X, U, B, y))
    want = RefEngine("xla-ref").grad_U(jU, jB, jX, jy)
    got = AltgdminEngine("torch-ref").grad_U(tU, tB, tX, ty)
    assert got.dtype == torch.float64
    _close(got, want, dict(rtol=0, atol=1e-10))
    # the two-launch min_grad of the sample-split path
    Bm_ref, G_ref = RefEngine("xla-ref").min_grad(jU, jX, jy, jX[::-1],
                                                   jy[::-1], same_data=False)
    Bm, G = AltgdminEngine("torch-ref").min_grad(
        tU, tX, ty, tX.flip(0), ty.flip(0), same_data=False)
    _close(Bm, Bm_ref, dict(rtol=0, atol=1e-10))
    _close(G, G_ref, dict(rtol=0, atol=1e-10))


# ---------------------------------------------------------------- top-k

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N,d,r,k", [(5, 32, 3, 8), (3, 12, 2, 12),
                                     (4, 97, 4, 24), (2, 40, 10, 1)])
def test_compress_topk_matches_xla_ref(N, d, r, k, dtype):
    M = np.random.default_rng(d + k).standard_normal((N, d, r))
    v_ref, i_ref = rops.compress_topk(jnp.asarray(M, getattr(jnp, dtype)),
                                      k, backend="xla-ref")
    v, i = ops.compress_topk(torch.as_tensor(M).to(getattr(torch, dtype)),
                             k)
    assert i.dtype == torch.int32 and v.dtype == getattr(torch, dtype)
    _equal(i, i_ref)
    _equal(v, v_ref)


def test_compress_topk_ties_and_full_k():
    """Equal norms keep index order (duplicated rows), and k = d returns
    every row once, in descending norm order."""
    rng = np.random.default_rng(0)
    M = torch.as_tensor(rng.standard_normal((2, 10, 3)), dtype=torch.float32)
    M[:, 7] = M[:, 2]                      # exact ties: 2 must come first
    M[:, 9] = M[:, 2]
    vals, idx = ops.compress_topk(M, 10)
    for g in range(2):
        order = idx[g].tolist()
        assert sorted(order) == list(range(10))
        assert order.index(2) < order.index(7) < order.index(9)
    norms = (M * M).sum(-1)
    assert torch.all(torch.gather(norms, 1, idx.long()).diff(dim=1) <= 0)
    out = consensus._scatter_replace_rows(torch.zeros_like(M), vals, idx)
    assert torch.equal(out, M)


# -------------------------------------------------------------- dequant

@pytest.mark.parametrize("backend", ["pallas-interpret", "xla-ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_equals_reference(dtype, backend):
    rng = np.random.default_rng(5)
    q = rng.integers(-127, 128, (4, 20, 3)).astype(np.int8)
    scale = (np.abs(rng.standard_normal((4, 1, 1))) + 1e-3)
    jscale = jnp.asarray(scale, getattr(jnp, dtype))
    want = rops.dequant(jnp.asarray(q), jscale, backend=backend)
    tscale = torch.as_tensor(scale).to(getattr(torch, dtype))
    got = ops.dequant(torch.as_tensor(q), tscale)
    assert got.dtype == tscale.dtype
    _equal(got.to(torch.float32), np.asarray(want, np.float32))


# ----------------------------------------------------------- validation

def test_validation_errors():
    M = torch.ones((2, 8, 2))
    with pytest.raises(ValueError, match="1 <= k <= d"):
        ops.compress_topk(M, 0)
    with pytest.raises(ValueError, match="1 <= k <= d"):
        ops.compress_topk(M, 9)
    with pytest.raises(ValueError, match=r"\(N, d, r\)"):
        ops.compress_topk(M[0], 2)
    q = torch.zeros((2, 8, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\(N, 1, 1\)"):
        ops.dequant(q, torch.ones(2))
    with pytest.raises(ValueError, match=r"\(N, 1, 1\)"):
        ops.dequant(q, torch.ones((3, 1, 1)))
    # cuda on CPU tensors raises; the kernel wrappers launch or raise
    X, U, B, y = (torch.as_tensor(a, dtype=torch.float32)
                  for a in _grad_instance(*CASES[0]))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.altgdmin_node_gradient(X, U, B, y, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.compress_topk(M, 2, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.dequant(q, torch.ones((2, 1, 1)), backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        altgdmin_ls.node_task_grad_tiles(X, U, B, y)
    with pytest.raises(ValueError, match="CUDA device"):
        compress.compress_topk(M, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        compress.dequant(q, torch.ones((2, 1, 1)))


# ---------------------------------------------------------------- rules

RULES = [("topk_gossip", {"compression_k": 7}),
         ("topk_gossip", {"compression_k": 3, "consensus_gamma": 0.5}),
         ("quantized_gossip", {}),
         ("quantized_gossip", {"compression": "int8"}),
         ("quantized_gossip", {"compression": "int8",
                               "consensus_gamma": 0.7}),
         ("event_gossip", {"event_threshold": 0.05})]


def _mixing(L, seed=0):
    from repro_torch.distributed import graphs, mixing
    return mixing.metropolis_weights(graphs.erdos_renyi(L, 0.6, seed=seed))


@pytest.mark.parametrize("rule,kw", RULES)
def test_state_mixer_f64_matches_reference(rule, kw):
    """From init_state, three calls of T_con = 3 rounds on drifting
    iterates: Z' and the public copies within 1e-12 of xla-ref."""
    L, d, r = 6, 20, 3
    W = _mixing(L)
    rng = np.random.default_rng(7)
    Zs = [rng.standard_normal((L, d, r)) for _ in range(3)]
    rmix = ref_get_rule(rule).make_sim_state_mixer(
        jnp.asarray(W), 3, backend="xla-ref", **kw)
    tmix = consensus.get_rule(rule).make_sim_state_mixer(
        torch.as_tensor(W), 3, backend="torch-ref", **kw)
    kw_state = {k: v for k, v in kw.items() if k != "consensus_gamma"}
    rst = ref_get_rule(rule).init_state(jnp.asarray(Zs[0]), **kw_state)
    tst = consensus.get_rule(rule).init_state(torch.as_tensor(Zs[0]),
                                              **kw_state)
    for Z in Zs:
        rZ, rst = rmix(jnp.asarray(Z), rst)
        tZ, tst = tmix(torch.as_tensor(Z), tst)
        assert tZ.dtype == torch.float64
        _close(tZ, rZ, F64)
        _close(tst, rst, F64)


@pytest.mark.parametrize("rule,kw", [("topk_gossip", {"compression_k": 20}),
                                     ("event_gossip", {})])
def test_lossless_refresh_is_dense_gossip_bit_for_bit(rule, kw):
    """k = d and θ = 0 refresh every copy with the exact iterate: the
    round is the dense W @ Z product bit for bit on torch-ref."""
    L, d, r = 6, 20, 3
    W = torch.as_tensor(_mixing(L, seed=1))
    Z = torch.as_tensor(np.random.default_rng(8).standard_normal((L, d, r)))
    dense = consensus.get_rule("gossip").make_sim_mixer(W, 4)
    mix = consensus.get_rule(rule).make_sim_state_mixer(W, 4, **kw)
    out, state = mix(Z, consensus.get_rule(rule).init_state(Z, **kw))
    assert torch.equal(out, dense(Z))


def test_consensus_gamma_relaxes_each_round():
    """γ ≠ 1: each round is Z + γ(combine(Z) − Z); with a lossless
    refresh that is Z + γ(WZ − Z), round by round."""
    L, d, r, gamma = 5, 8, 2, 0.3
    W = torch.as_tensor(_mixing(L, seed=2))
    Z = torch.as_tensor(np.random.default_rng(9).standard_normal((L, d, r)))
    mix = consensus.get_rule("event_gossip").make_sim_state_mixer(
        W, 2, consensus_gamma=gamma)
    out, _ = mix(Z, torch.zeros_like(Z))
    want = Z
    for _ in range(2):
        want = want + gamma * (torch.einsum("gh,hdr->gdr", W, want) - want)
    _close(out, want.numpy(), dict(rtol=0, atol=1e-13))
    plain = consensus.get_rule("event_gossip").make_sim_state_mixer(W, 2)
    assert not torch.allclose(plain(Z, torch.zeros_like(Z))[0], out)


@pytest.mark.parametrize("rule", ["topk_gossip", "quantized_gossip",
                                  "event_gossip"])
def test_stateless_mixer_raises_type_error(rule):
    with pytest.raises(TypeError, match="stateful"):
        consensus.get_rule(rule).make_sim_mixer(torch.eye(3), 2)


def test_bad_wire_and_knobs_rejected():
    qr = consensus.get_rule("quantized_gossip")
    with pytest.raises(ValueError, match="wire format"):
        qr.resolve_params(10, 2, compression="fp4")
    with pytest.raises(ValueError, match="compression_k"):
        consensus.get_rule("topk_gossip").resolve_params(10, 2,
                                                         compression_k=11)
    with pytest.raises(ValueError, match="event_threshold"):
        consensus.get_rule("event_gossip").resolve_params(
            10, 2, event_threshold=-1.0)


@pytest.mark.parametrize("rule,kw", [
    ("topk_gossip", {"compression_k": 9}), ("topk_gossip", {}),
    ("quantized_gossip", {}), ("quantized_gossip", {"compression": "int8"}),
    ("event_gossip", {})])
def test_signatures_match_reference(rule, kw):
    for dims in ({}, {"d": 36, "r": 3}):
        assert (consensus.get_rule(rule).signature(4, **dims, **kw).__dict__
                == ref_get_rule(rule).signature(4, **dims, **kw).__dict__)


# --------------------------------------------------- stochastic int8 wire

def test_stochastic_dither_is_per_count_and_node():
    ids = torch.arange(6)
    u = consensus.stochastic_dither(3, ids, (10, 3), torch.float64)
    assert u.shape == (6, 10, 3) and u.dtype == torch.float64
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # the same draw for the same (count, node), whatever else is drawn
    alone = consensus.stochastic_dither(3, torch.tensor([4]), (10, 3),
                                        torch.float64)
    assert torch.equal(alone[0], u[4])
    assert torch.equal(consensus.stochastic_dither(3, ids, (10, 3),
                                                   torch.float64), u)
    assert not torch.equal(consensus.stochastic_dither(4, ids, (10, 3),
                                                       torch.float64), u)
    assert not torch.equal(u[0], u[1])
    f32 = consensus.stochastic_dither(0, ids, (10, 3), torch.float32)
    assert f32.dtype == torch.float32 and float(f32.max()) < 1.0
    many = consensus.stochastic_dither(0, torch.arange(4000), (5,),
                                       torch.float64)
    assert abs(float(many.mean()) - 0.5) < 0.01


def test_stochastic_int8_is_bounded_and_unbiased():
    """|q| ≤ 127, and the dequantized increment averages to the
    difference it encodes (E[floor(x + u)] = x)."""
    rule = consensus.get_rule("quantized_gossip")
    rng = np.random.default_rng(11)
    Z = torch.as_tensor(rng.standard_normal((3, 8, 2)))
    xhat = torch.zeros_like(Z)
    ids = torch.arange(3)
    delta = Z - xhat
    scale = rule._int8_scale(delta)
    incs = []
    for count in range(2000):
        (q, s), xhat2 = rule.refresh(Z, xhat, ids, count,
                                     backend="torch-ref",
                                     wire="int8_stochastic")
        assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
        assert torch.equal(s, scale)
        incs.append(xhat2 - xhat)
    mean = torch.stack(incs).mean(0)
    assert float(((mean - delta).abs() / scale).max()) < 0.05
    # the round counter rides the state as a Python int
    st = rule.init_state(Z, compression="int8_stochastic")
    assert st[1] == 0 and isinstance(st[1], int)
    mix = rule.make_sim_state_mixer(torch.eye(3, dtype=Z.dtype), 4,
                                    compression="int8_stochastic")
    _, st = mix(Z, st)
    assert st[1] == 4 and isinstance(st[1], int)


def test_mantissa_bits():
    assert consensus._mantissa_bits(torch.float32) == 24
    assert consensus._mantissa_bits(torch.float64) == 53
    assert consensus._mantissa_bits(torch.bfloat16) == 8
