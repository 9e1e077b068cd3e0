"""The four assigned input shapes and the per-(arch, shape) admissibility.

Port of ``src/repro/launch/shapes.py`` over the port's
:class:`~repro_torch.configs.base.ModelConfig`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


LONG_CTX_WINDOW = 8_192    # the sliding-window variant for 500k


def long_ctx_variant(cfg):
    """Config actually run for long_500k: SSM, hybrid and windowed archs
    run as they are (sub-quadratic state); full-attention archs get the
    sliding-window variant (window 8192), which makes a 524288-token
    decode admissible.  → (cfg, note)."""
    if cfg.is_subquadratic:
        return cfg, ""
    variant = dataclasses.replace(cfg, sliding_window=LONG_CTX_WINDOW,
                                  name=cfg.name + "+swa8k")
    return variant, (f"{cfg.name}: full attention at 524k is inadmissible "
                     f"(85 GB-class KV cache); lowered the sliding-window "
                     f"variant (window={LONG_CTX_WINDOW}) instead")


def admissible(cfg, shape: InputShape) -> tuple[bool, str]:
    """Every assigned arch is a decoder (no encoder-only decode skips);
    long_500k is handled through :func:`long_ctx_variant`."""
    return True, ""


def cache_capacity(cfg, shape: InputShape) -> int:
    """KV-cache slots for a decode shape: the full context, cut to the
    sliding window where there is one (a ring buffer)."""
    cap = shape.seq_len
    if cfg.sliding_window is not None:
        cap = min(cap, cfg.sliding_window)
    return cap
