"""The language models of the zoo: port of ``src/repro/models/`` for the
serving and training paths of every plan (dense GQA, MLA and MoE stacks,
Mamba2 stacks, the zamba hybrid) and the stub frontends."""
from repro_torch.models.transformer import (
    LanguageModel, count_params, decode_step, forward, init_cache,
    init_params,
)
from repro_torch.models.convert import params_from_jax

__all__ = ["LanguageModel", "count_params", "decode_step", "forward",
           "init_cache", "init_params", "params_from_jax"]
