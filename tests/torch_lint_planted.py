"""Planted violations for the port's static checks (not a test file).

Each object here breaks one structural contract of the solver programs
on purpose, so the tests of ``repro_torch.analysis`` can show that the
matching rule catches it.  The bodies are compiled under the file name
``src/repro_torch/core/planted.py`` (a file that does not exist), so the
run rules locate their ops there, as they locate the port's own code;
the programs are not registered, and a spawned rank reaches them as
``"torch_lint_planted:<NAME>"`` (this directory is on every rank's
path, as it is on the test process's).
"""
import dataclasses
import os

import torch

from repro_torch.core.program import SolverProgram, get_program
from repro_torch.distributed.consensus import (COMBINE_RULES, GossipCombine,
                                               register_rule)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANTED_PATH = "src/repro_torch/core/planted.py"

# the first line of each body is line 2 of the planted file
PLANTED_SRC = '''
def _upd_twice(ctx, U, aux, tau):
    _, G = ctx.min_grad(U, tau)
    _, G = ctx.min_grad(U, tau)
    return ctx.qr(ctx.mix(U - ctx.eta_L * G)), aux, None


def _upd_eye(ctx, U, aux, tau):
    _, G = ctx.min_grad(U, tau)
    eye = torch.eye(U.shape[0], dtype=U.dtype)
    U_breve = torch.einsum("gh,h...->g...", eye, U - ctx.eta_L * G)
    return ctx.qr(ctx.mix(U_breve)), aux, None


def planted_dense(x):
    return torch.einsum("id,jd->ij", x, x)


def planted_passthrough(W):
    return (2.0 * W).T


def planted_narrow(x):
    return x.to(torch.float32) * 2.0


def planted_widen(x):
    return x.to(torch.float64) + 1.0
'''
# line numbers of the planted ops in PLANTED_PATH
LINE_EYE = 10
LINE_DENSE = 16
LINE_NARROW = 24

_namespace = {"torch": torch}
exec(compile(PLANTED_SRC, os.path.join(REPO_ROOT, PLANTED_PATH), "exec"),
     _namespace)
planted_dense = _namespace["planted_dense"]
planted_passthrough = _namespace["planted_passthrough"]
planted_narrow = _namespace["planted_narrow"]
planted_widen = _namespace["planted_widen"]

_dif = get_program("dif_altgdmin")

# JX001: one kernel (node_fused_iter) launched twice an iteration
TWICE = dataclasses.replace(_dif, name="planted_twice",
                            update=_namespace["_upd_twice"])

# JX002: an (L, L) identity born in the update, on any tier
EYE = dataclasses.replace(_dif, name="planted_eye",
                          update=_namespace["_upd_eye"])


class _OneMoreSend:
    """A NodeMesh whose every ``ppermute_many`` fetches one more block
    (shift 1) than asked, and drops it: one extra send a round."""

    def __init__(self, mesh):
        self._mesh = mesh

    def __getattr__(self, name):
        return getattr(self._mesh, name)

    def ppermute_many(self, z, shifts):
        return self._mesh.ppermute_many(z, tuple(shifts) + (1,))[:-1]


class ExtraSendGossip(GossipCombine):
    """The paper's gossip, priced as gossip, whose mesh rounds each send
    one message more than the signature prices."""

    name = "planted_extra_send"

    def make_mesh_mixer(self, mesh, *args, **kw):
        return super().make_mesh_mixer(_OneMoreSend(mesh), *args, **kw)


if ExtraSendGossip.name not in COMBINE_RULES:
    register_rule(ExtraSendGossip())

# JX004: Dif-AltGDmin over that rule, with Dif-AltGDmin's budget
EXTRA_SEND = dataclasses.replace(_dif, name="planted_extra_send",
                                 combine=ExtraSendGossip.name)
