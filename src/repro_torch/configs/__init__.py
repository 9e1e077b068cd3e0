"""Architecture registry: ``get_config("<arch-id>")`` returns the exact
configuration of one architecture of the zoo; every entry cites its
source in ``citation``.

The port's own copy of ``src/repro/configs/__init__.py`` and of the ten
preset modules beside it, as data.  The paper's linear-MTRL presets are
in :mod:`repro_torch.configs.paper`.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

_PRESETS = (
    # [dense] llama-arch, code; MQA
    dict(name="granite-20b", arch_type="dense", n_layers=52, d_model=6144,
         n_heads=48, n_kv_heads=1, d_ff=24576, vocab_size=49152,
         citation="arXiv:2405.04324"),
    # [dense] GQA, no bias, parallel attn ∥ FFN blocks
    dict(name="command-r-35b", arch_type="dense", n_layers=40, d_model=8192,
         n_heads=64, n_kv_heads=8, d_ff=22528, vocab_size=256000,
         attn_bias=False, parallel_block=True, rope_theta=8_000_000.0,
         citation="hf:CohereForAI/c4ai-command-r-v01"),
    # [hybrid] Mamba2 backbone + weight-tied shared attention every 6th
    # layer (13 groups of 6 + 3 trailing mamba layers); the window makes
    # the 500k decode admissible
    dict(name="zamba2-7b", arch_type="hybrid", n_layers=81, d_model=3584,
         n_heads=32, n_kv_heads=32, d_ff=14336, vocab_size=32000,
         block_pattern="zamba", shared_attn_period=6, ssm_state=64,
         ssm_headdim=64, ssm_expand=2, sliding_window=8192,
         citation="arXiv:2411.15242"),
    # [moe] 128 experts top-2 + a dense FFN residual branch every layer
    dict(name="arctic-480b", arch_type="moe", n_layers=35, d_model=7168,
         n_heads=56, n_kv_heads=8, d_ff=4864, vocab_size=32000,
         n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
         citation="hf:Snowflake/snowflake-arctic-base"),
    # [ssm] attention-free SSD; d_inner = 1536, 24 heads of dim 64
    dict(name="mamba2-130m", arch_type="ssm", n_layers=24, d_model=768,
         n_heads=0, n_kv_heads=0, d_head=64, d_ff=0, vocab_size=50280,
         attn_impl="none", block_pattern="ssm", ssm_state=128,
         ssm_headdim=64, ssm_expand=2, tie_embeddings=True,
         citation="arXiv:2405.21060"),
    # [dense] RoPE, SwiGLU, GQA
    dict(name="phi4-mini-3.8b", arch_type="dense", n_layers=32, d_model=3072,
         n_heads=24, n_kv_heads=8, d_ff=8192, vocab_size=200064,
         tie_embeddings=True, citation="arXiv:2412.08905"),
    # [moe] MLA, 1 shared + 256 routed experts top-8, first 3 layers
    # dense, sigmoid router scores (the MTP head is omitted)
    dict(name="deepseek-v3-671b", arch_type="moe", n_layers=61, d_model=7168,
         n_heads=128, n_kv_heads=128, d_ff=18432, vocab_size=129280,
         attn_impl="mla", q_lora_rank=1536, kv_lora_rank=512,
         rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
         n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
         first_dense_layers=3, router_score="sigmoid_norm",
         citation="arXiv:2412.19437"),
    # [dense] GQA + qk-norm
    dict(name="qwen3-1.7b", arch_type="dense", n_layers=28, d_model=2048,
         n_heads=16, n_kv_heads=8, d_ff=6144, vocab_size=151936,
         qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=True,
         citation="hf:Qwen/Qwen3-8B"),
    # [audio] decoder-only over EnCodec tokens (the codec is the stubbed
    # frontend)
    dict(name="musicgen-medium", arch_type="audio", n_layers=48,
         d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048,
         modality="audio", citation="arXiv:2306.05284"),
    # [vlm] mistral-7b backbone + anyres tiling (5 tiles × 576 patch
    # tokens); sliding-window attention
    dict(name="llava-next-mistral-7b", arch_type="vlm", n_layers=32,
         d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
         vocab_size=32000, modality="vlm", vis_tokens=2880,
         sliding_window=4096, rope_theta=10_000.0,
         citation="hf:llava-hf/llava-v1.6-mistral-7b-hf"),
)

REGISTRY: dict[str, ModelConfig] = {
    p["name"]: ModelConfig(**p) for p in _PRESETS}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
