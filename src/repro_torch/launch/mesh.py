"""Production meshes as plain descriptions, and the card's roofline
constants.

Port of ``src/repro/launch/mesh.py``.  A mesh here is a
:class:`MeshShape`, the names and sizes of its axes in order: no process
group and no device, only the layout that the sharding rules
(:mod:`repro_torch.launch.sharding`) and the dry run
(:mod:`repro_torch.launch.dryrun`) read.  The production layouts are
the reference's, so the spec trees of both packages compare leaf for
leaf:

  single pod  (data 16, model 16)          — 256 devices;
  multi-pod   (pod 2, data 16, model 16)   — 512 devices, the ``pod``
              axis the slow link between two groups of 256, where the
              paper's decentralized nodes sit.

The roofline constants are one NVIDIA H100 SXM's ("NVIDIA H100 80GB
HBM3", 700.00 W power limit), from NVIDIA's data sheet, dense rates
without sparsity; a card set below 700 W runs slower.  ``chip_smoke.py``
reads its peaks from here, so they have one source.  Importing this
module imports nothing but the standard library.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, at the 700 W power limit
PEAK_FLOPS_BF16 = 989e12        # dense bf16 on the tensor cores, a card
PEAK_FLOPS_F32 = 67e12          # float32 outside the tensor cores
HBM_BW = 3.35e12                # HBM3 bytes/s a card
NVLINK_BW = 450e9               # NVLink 4 bytes/s a card, one direction
HBM_BYTES = 80e9                # bytes of HBM a card


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes (names and sizes, in order) and, for a host mesh,
    the device its one process computes on."""
    axis_names: tuple
    sizes: tuple
    device: str | None = None

    @property
    def shape(self) -> dict:
        """``{axis name: size}`` in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes, strict=True))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def node_axes(mesh) -> tuple:
    """Mesh axes that carry the decentralized node dimension (the leading
    param/batch axis of the diffusion trainer)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def n_nodes(mesh) -> int:
    out = 1
    for a in node_axes(mesh):
        out *= mesh.shape[a]
    return out


def n_chips(mesh) -> int:
    out = 1
    for a in mesh.shape:
        out *= mesh.shape[a]
    return out


def make_host_mesh(device=None) -> MeshShape:
    """The local devices as a (data n, model 1) mesh: n the cards of
    this host, or 1 for ``device="cpu"`` (or ``"meta"``).  ``device``
    None means the card, and raises RuntimeError when there is none."""
    import torch

    from repro_torch.api.runner import resolve_device
    device = resolve_device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    return MeshShape(("data", "model"), (n, 1), device=str(device))
