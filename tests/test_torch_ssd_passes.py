"""The three-pass decomposition of the bf16 ``ssd_scan`` kernels
(``src/repro_torch/kernels/csrc/ssd_scan.cu``), as plain torch on the CPU,
against the JAX package.

The model below is the kernels' arithmetic in their scratch layout:
chunk states S_c (B, H, nc, P, N) f32 and seg (B, H, nc) from pass 1,
the states entering each chunk h_c (B, H, nc, P, N) from pass 2, and the
chunk outputs of pass 3.  ``rounded`` puts in the kernels' bf16 rounding
points -- x exp(seg - cum) dt, h_c and M = C Bᵀ ∘ L ∘ dt, the operands of
the three tensor-core products -- and writes y in bf16.

* Unrounded, at f32, it is held to the JAX package's ``ops.ssd_scan`` on
  ``pallas-interpret`` and to its ``ref.ref_ssd`` at rtol = atol = 1e-4
  (tests/test_kernels.py's f32 tolerance), ragged S, chunks of 8 and 16
  and S < Q included; each h_c is the recurrence's state after the
  tokens before chunk c.
* Rounded, on bf16 inputs, it stays within the bf16 tolerance 5e-2 of
  the same references, at those shapes and at mamba2-130m's widths with
  S cut to 512.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402

f32 = torch.float32
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (B, S, H, P, N, chunk): tests/test_kernels.py's shapes (Q 8 and 16, a
# ragged S = 20), a ragged S with Q 16, and S < Q
SHAPES = [(1, 32, 2, 16, 8, 8), (2, 48, 3, 8, 16, 16), (1, 20, 2, 16, 8, 8),
          (2, 37, 2, 8, 8, 16), (1, 12, 2, 8, 8, 16)]
# mamba2-130m's widths (H 24, P 64, N 128, Q 128), S cut to 512
MAMBA2_CUT = (1, 512, 24, 64, 128, 128)


def _bf16(t):
    return t.to(torch.bfloat16).to(f32)


def three_pass(x, dt, A, Bm, Cm, D, chunk, *, rounded=False):
    """The kernels' three passes.  x (B, S, H, P), dt (B, S, H), A and D
    (H,), Bm/Cm (B, S, N), float32 → (y (B, S, H, P), h_final
    (B, H, P, N), h_c (B, H, nc, P, N), seg (B, H, nc))."""
    rnd = _bf16 if rounded else (lambda t: t)
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = math.ceil(S / Q)
    pad = nc * Q - S

    def chunks(t):               # tokens past S read as zeros, dt too
        t = torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        return t.reshape(Bb, nc, Q, *t.shape[2:])

    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(Bm), chunks(Cm)
    cum = torch.cumsum(dtc * A, dim=2)                      # (B, nc, Q, H)
    seg = cum[:, :, -1]                                     # (B, nc, H)

    # pass 1: S_c = (x ∘ exp(seg - cum) dt)ᵀ B
    w = torch.exp(seg[:, :, None] - cum) * dtc
    xs = rnd(xc * w[..., None])
    states = torch.einsum("bcqhp,bcqn->bhcpn", xs, Bc)      # (B, H, nc, P, N)
    segs = seg.permute(0, 2, 1)                             # (B, H, nc)

    # pass 2: h_0 = 0, h_c = exp(seg_{c-1}) h_{c-1} + S_{c-1}
    hc = torch.zeros_like(states)
    hv = torch.zeros_like(states[:, :, 0])
    for c in range(nc):
        hc[:, :, c] = hv
        hv = torch.exp(segs[:, :, c])[..., None, None] * hv + states[:, :, c]

    # pass 3: y = exp(cum_i) (C_i h_cᵀ) + (C Bᵀ ∘ L ∘ dt) x + D x
    i = torch.arange(Q)
    below = (i[:, None] >= i[None, :])[None, None, :, :, None]
    diff = cum[:, :, :, None] - cum[:, :, None]             # (B, nc, i, j, H)
    L = torch.where(below, diff, -torch.inf).exp()
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    M = rnd(scores[..., None] * L * dtc[:, :, None])
    y = (torch.einsum("bcijh,bcjhp->bcihp", M, xc)
         + torch.exp(cum)[..., None]
         * torch.einsum("bcin,bhcpn->bcihp", Cc, rnd(hc))
         + xc * D[:, None])
    y = y.reshape(Bb, nc * Q, H, P)[:, :S]
    return (rnd(y), hv, hc, segs)


def _inputs(B, S, H, P, N, dtype, seed=7):
    """numpy inputs from a seed, tests/test_kernels.py's draws: x, Bm, Cm
    rounded to ``dtype`` (numpy for JAX, float32 torch for the model)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    cast = ((lambda a: a.astype(ml_dtypes.bfloat16)) if dtype == "bfloat16"
            else (lambda a: a))
    x, Bm, Cm = cast(f(B, S, H, P)), cast(f(B, S, N)), cast(f(B, S, N))
    dt = (np.log1p(np.exp(f(B, S, H))) * np.float32(0.1)).astype(np.float32)
    A = (-np.exp(f(H) * np.float32(0.3))).astype(np.float32)
    D = np.full((H,), 0.5, np.float32)
    jax_args = tuple(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D))
    torch_args = tuple(torch.from_numpy(np.asarray(a, np.float32))
                       for a in (x, dt, A, Bm, Cm, D))
    return jax_args, torch_args


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_three_passes_match_jax_pallas_and_ref(B, S, H, P, N, chunk):
    jax_args, args = _inputs(B, S, H, P, N, "float32")
    y, h, _, _ = three_pass(*args, chunk)
    y_pl, h_pl = rops.ssd_scan(*jax_args, chunk=chunk,
                               backend="pallas-interpret")
    y_ref, h_ref = rref.ref_ssd(*jax_args)
    for want_y, want_h in ((y_pl, h_pl), (y_ref, h_ref)):
        _close(y.numpy(), want_y, TOL["float32"])
        _close(h.numpy(), want_h, TOL["float32"])


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_state_entering_each_chunk_is_the_recurrence_state(B, S, H, P, N,
                                                           chunk):
    """Pass 2's h_c is the state after the c·Q tokens before chunk c (the
    likeliest off-by-one of the three passes), and seg is the chunk's
    whole decay."""
    jax_args, args = _inputs(B, S, H, P, N, "float32", seed=8)
    _, _, hc, segs = three_pass(*args, chunk)
    nc = hc.shape[2]
    assert hc.shape == (B, H, nc, P, N) and segs.shape == (B, H, nc)
    assert not hc[:, :, 0].any()
    for c in range(1, nc):
        head = tuple(a[:, :c * chunk] if a.ndim > 1 else a
                     for a in jax_args)
        _, h_before = rref.ref_ssd(*head)
        _close(hc[:, :, c].numpy(), h_before, TOL["float32"])
    x, dt, A = args[:3]
    dA = torch.nn.functional.pad(dt * A, (0, 0, 0, nc * chunk - S))
    _close(segs.numpy(),
           dA.reshape(B, nc, chunk, H).sum(2).permute(0, 2, 1).numpy(),
           TOL["float32"])


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES + [MAMBA2_CUT])
def test_bf16_rounding_points_stay_within_the_bf16_tolerance(B, S, H, P, N,
                                                             chunk):
    """The kernels' rounding of x exp(seg - cum) dt, h_c and M to bf16, on
    bf16 inputs, against the unrounded references (pallas-interpret at
    the small shapes, the recurrence everywhere)."""
    jax_args, args = _inputs(B, S, H, P, N, "bfloat16", seed=9)
    y, h, _, _ = three_pass(*args, chunk, rounded=True)
    wants = [rref.ref_ssd(*jax_args)]
    if S <= 64:
        wants.append(rops.ssd_scan(*jax_args, chunk=chunk,
                                   backend="pallas-interpret"))
    for want_y, want_h in wants:
        _close(y.numpy(), np.asarray(want_y, np.float32), TOL["bfloat16"])
        _close(h.numpy(), want_h, TOL["bfloat16"])
    # the rounding is felt: the rounded model is not the unrounded one
    y_exact, _, _, _ = three_pass(*args, chunk)
    assert float((y - y_exact).abs().max()) > 0
