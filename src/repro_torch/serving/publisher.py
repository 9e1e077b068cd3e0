"""Representation lifecycle: publish U snapshots during training,
hot-swap them into the serving engine.

Port of ``src/repro/serving/publisher.py``.  The training side
(``run_experiment(..., checkpoint_every=k, checkpoint_dir=...)``)
publishes the node bases every k outer iterations through
:func:`publish_representation`: the deployable single basis
U = QR(mean_g U_g) — the consensus representative the nodes contract
toward — lands next to the raw (L, d, r) stack in one crash-safe
checkpoint (see :mod:`repro_torch.checkpoint.store`).

The serving side polls :class:`HotSwapSource` between batches: it
re-reads ``latest_step`` (one listdir) and restores only when a NEWER
complete step appeared, so the server tracks a drifting U while
consensus keeps refining it.
"""
from __future__ import annotations

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.spectral import _qr_pos


def deployable_basis(U_nodes):
    """The single served basis from a stack of node bases: orthonormalize
    the node mean (sign-fixed QR).  A (d, r) input passes through the
    same retraction, so both layouts publish an orthonormal U."""
    U = torch.as_tensor(U_nodes)
    if U.ndim == 3:
        U = torch.mean(U, dim=0)
    return _qr_pos(U)[0]


def publish_representation(directory: str, step: int, U_nodes) -> str:
    """Write checkpoint ``step``: {"U": deployable (d, r), "U_nodes":
    raw stack}.  Crash-safe via the store's stage-then-rename."""
    U_nodes = torch.as_tensor(U_nodes)
    tree = {"U": deployable_basis(U_nodes),
            "U_nodes": U_nodes if U_nodes.ndim == 3 else U_nodes[None]}
    return save_checkpoint(directory, step, tree)


def load_representation(directory: str, step: int, *, d: int, r: int,
                        dtype=torch.float32, device=None):
    """Restore just the deployable U of checkpoint ``step``, on
    ``device`` (None: the card)."""
    like = {"U": torch.zeros((d, r), dtype=dtype,
                             device=resolve_device(device))}
    return restore_checkpoint(directory, step, like)["U"]


class RepresentationPublisher:
    """Cadenced publisher: ``maybe(step, U_nodes)`` writes every
    ``every`` steps (and always at step 0); ``published`` records the
    steps written, in order."""

    def __init__(self, directory: str, *, every: int = 1):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.directory = directory
        self.every = int(every)
        self.published: list = []

    def maybe(self, step: int, U_nodes) -> bool:
        if step % self.every and step != 0:
            return False
        self.publish(step, U_nodes)
        return True

    def publish(self, step: int, U_nodes) -> str:
        path = publish_representation(self.directory, step, U_nodes)
        self.published.append(int(step))
        return path


class HotSwapSource:
    """Poll-based reader for the serving loop.

    ``poll()`` returns ``(step, U)`` when a complete checkpoint newer
    than the last one served exists, else None; U lands on ``device``
    (None: the card).  A partially written save is invisible
    (``latest_step`` requires the manifest, which lands atomically), so
    the server can poll mid-training safely."""

    def __init__(self, directory: str, *, d: int, r: int,
                 dtype=torch.float32, device=None):
        self.directory = directory
        self.d, self.r = int(d), int(r)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.last_step: int | None = None

    def poll(self):
        step = latest_step(self.directory)
        if step is None or (self.last_step is not None
                            and step <= self.last_step):
            return None
        U = load_representation(self.directory, step, d=self.d, r=self.r,
                                dtype=self.dtype, device=self.device)
        self.last_step = step
        return step, U
