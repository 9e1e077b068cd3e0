"""The port's trainer against the JAX package's on the smoke variants of
the plans past the ``scan`` stacks, on the CPU: arctic-480b (MoE with a
dense residual), deepseek-v3-671b (MLA, a leading dense layer, MoE with
a shared expert and the sigmoid router), zamba2-7b (SSM groups around
the shared attention block), llava-next-mistral-7b (patch embeddings
before the text), and the four presets that share the ``scan`` plan with
their own attention forms: granite-20b (MQA, one KV head),
command-r-35b (the parallel attention ∥ FFN block), phi4-mini-3.8b (GQA
24/8, tied embeddings) and musicgen-medium (MHA at head dim 64, the
audio token stream).  One fused diffusion step's per-node losses and
gradients, and the losses of two, against the JAX package's own jitted
``make_train_step_fused``; the MoE aux loss is inside every loss.  The
tolerances, and why, are in the docstring of
``tests/torch_train_parity.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_train_parity import (  # noqa: E402,F401
    check_fused_step, one_torch_thread,
)


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b",
                                  "zamba2-7b", "llava-next-mistral-7b",
                                  "granite-20b", "command-r-35b",
                                  "phi4-mini-3.8b", "musicgen-medium"])
def test_fused_diffusion_step_matches_jax(arch):
    check_fused_step(arch)
