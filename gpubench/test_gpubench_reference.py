"""The plain references held to the port at a small size on the CPU, in
float32: the Mamba2 stack's decentralized train step, under each combine
a mix can state, and the dense decoder's prefill.  The program's side
runs through the benchmark's own drivers, so the weights, the feed and
the readings are the run's."""
from __future__ import annotations

import pytest
import torch

from gpubench import check, tiny, weights as W
from gpubench.entries import prefill, train
from gpubench.reference import common as C, dense, mamba2

CPU = torch.device("cpu")
# the port's strategy, and what it means as the reference does it
MIXES = {
    "diffusion": ({"strategy": "diffusion", "t_con": 2},
                  {"stage": "params", "rounds": 2, "shifts": [-1, 1]}),
    "local": ({"strategy": "local"}, {"stage": "params", "rounds": 0}),
    "allreduce": ({"strategy": "allreduce"},
                  {"stage": "grads", "rounds": 1, "shifts": [1, 2, 3],
                   "self_weight": 0.25}),
}


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
@pytest.mark.parametrize("mix", MIXES)
def test_mamba2_train_step_matches_the_port(seed, mix):
    config, traffic = tiny.cell("mamba2-2.7b.train.diffusion", "float32")
    agg, rule = MIXES[mix]
    traffic["aggregation"] = dict(traffic["aggregation"], **agg)
    traffic["combine"] = dict(traffic["combine"], **{"shifts": [], **rule})
    assert traffic["nodes"] == 4
    d = train.Driver(config, traffic, {}, seed, CPU)
    d.setup()
    got = d.finish()
    want = check.reference_train(config, traffic, d.shapes, seed, CPU)
    numbers = check.compare_train(got, want)
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_norm_gap"] < 1e-5
    assert numbers["change_norm_gap"] < 1e-4
    # every leaf of every node moved and had a gradient
    assert min(want["grad_norms"].values()) > 0
    assert len(got["grad_norms"]) == len(want["grad_norms"])


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_dense_prefill_matches_the_port(window, seed):
    config, traffic = tiny.cell("phi4-mini-3.8b.prefill.2k", "float32")
    config["model"]["sliding_window"] = window
    d = prefill.Driver(config, traffic, {"check_rows": 3}, seed, CPU)
    d.setup()
    for _ in range(2):
        d.call(d.prepare())
    rows = d.finish()
    assert len(rows) == 3
    params = W.make(d.shapes, config["init"], seed, CPU, serve=True)
    for tokens, logits in rows:
        want = dense.last_logits(params, tokens, config["model"])
        gap, rel, top = check.logit_numbers(logits, want)
        assert gap == 0.0 and rel < 1e-5 and top < 1e-5


@pytest.mark.parametrize("seed", [0, 2 ** 32 + 5])
def test_the_kept_answers_are_a_sample_of_all(seed):
    """Reservoir sampling keeps n rows, each of all seen alike likely,
    and the same ones for the same seed."""
    def kept(seed):
        s = prefill.Sample(4, seed)
        for u in range(50):
            s.add(torch.arange(3)[:, None] + 3 * u, torch.zeros(3, 2))
        return sorted(int(t[0]) for t, _ in s.rows)
    rows = kept(seed)
    assert len(set(rows)) == 4 and rows == kept(seed)
    counts = torch.zeros(150)
    for k in range(400):
        counts[kept(seed * 1000 + k)] += 1
    # each of 150 rows kept with probability 4/150: 10.7 in 400 draws
    assert float(counts[:75].sum()) == pytest.approx(800, rel=0.15)


def _sequential_ssd(x, dt, A, Bm, Cm):
    """The recurrence token by token: h ← exp(dt·A) h + dt B ⊗ x,
    y = C·h."""
    Bb, S, H, P = x.shape
    h = torch.zeros(Bb, H, P, Bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h + \
            (dt[:, t, :, None, None] * x[:, t, :, :, None]
             * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("S,chunk", [(40, 16), (64, 64), (7, 4)])
def test_reference_ssd_is_the_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    B, H, P, N = 2, 3, 4, 5
    x = torch.randn(B, S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(B, S, H, generator=g, dtype=torch.float64) * 0.3
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    Bm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    y = mamba2.ssd(x, dt, A, Bm, Cm, chunk)
    torch.testing.assert_close(y, _sequential_ssd(x, dt, A, Bm, Cm),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("window", [None, 5])
def test_blocked_attention_is_one_block(window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 19, 6, 8, generator=g)
    k = torch.randn(2, 19, 2, 8, generator=g)
    v = torch.randn(2, 19, 2, 8, generator=g)
    whole = C.causal_attention(q, k, v, window, block=1024)
    torch.testing.assert_close(C.causal_attention(q, k, v, window, block=4),
                               whole, rtol=1e-6, atol=1e-6)
    # the first query sees only itself
    torch.testing.assert_close(whole[:, 0], v[:, 0].repeat_interleave(3, 1))


def test_fp8_rounding_is_coarse_but_bounded():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    q = C.fp8_round(x)
    rel = (q - x).abs() / x.abs().clamp(min=1e-3)
    assert 1e-3 < float(rel.median()) < 0.07       # 3 mantissa bits
    assert float(q.abs().max()) == pytest.approx(float(x.abs().max()),
                                                 rel=1e-6)
    assert torch.equal(C.fp8_round(torch.zeros(3)), torch.zeros(3))


def test_the_schedule_warms_up_then_decays():
    opt = {"lr": 3e-4, "warmup_steps": 100, "total_steps": 1000}
    assert C.schedule(1, opt) == pytest.approx(3e-6)
    assert C.schedule(100, opt) == pytest.approx(3e-4)
    assert C.schedule(1000, opt) == pytest.approx(0.0, abs=1e-12)


def test_ring_mix_of_two_nodes_takes_two_thirds_of_the_other():
    z = torch.tensor([[3.0], [6.0]])
    torch.testing.assert_close(C.ring_mix(z, [-1, 1]),
                               torch.tensor([[5.0], [4.0]]))
