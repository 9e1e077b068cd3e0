"""ModelConfig — one composable dataclass describing every architecture in
the assigned zoo (dense / MoE / SSM / hybrid / audio / VLM decoders).

The port's own copy of ``src/repro/configs/base.py``, field for field, so
a preset means the same model in both packages.  The registry in
:mod:`repro_torch.configs` instantiates it with each architecture's
hyperparameters; ``smoke()`` derives the reduced variant used by the CPU
tests (≤2 layers, d_model ≤ 512, ≤4 experts).  ``remat`` and
``remat_policy`` checkpoint each block while autograd records (the
trainer; ``models.transformer._block``); ``unroll`` is a compile knob of
the JAX package that the port ignores.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None   # default d_model // n_heads

    # ---- attention flavour ------------------------------------------------
    attn_impl: str = "gqa"         # gqa | mla | none (pure SSM)
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None   # window size, None = full causal
    attn_bias: bool = False
    parallel_block: bool = False   # command-r: attn ∥ ffn residual

    # ---- MLA (deepseek-v3) ------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE ---------------------------------------------------------------
    n_experts: int = 0             # 0 ⇒ dense FFN
    top_k: int = 0
    n_shared_experts: int = 0      # deepseek: 1 shared expert
    moe_d_ff: Optional[int] = None # expert hidden dim (defaults to d_ff)
    dense_residual: bool = False   # arctic: dense FFN ∥ MoE
    first_dense_layers: int = 0    # deepseek: first k layers dense
    router_score: str = "softmax"  # softmax | sigmoid_norm (deepseek-v3)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ---- SSM / hybrid -------------------------------------------------------
    block_pattern: str = "attn"    # attn | ssm | zamba (ssm + shared attn)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    shared_attn_period: int = 6    # zamba: shared attn every k-th layer

    # ---- block / embedding structure ---------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp_bias: bool = False

    # ---- modality (stub frontends; see DESIGN.md carve-out) ----------------
    modality: str = "text"         # text | audio | vlm
    vis_tokens: int = 0            # vlm: anyres patch-embedding budget

    # ---- numerics / execution ----------------------------------------------
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"
    remat: bool = True             # checkpoint each scanned block
    remat_policy: str = "all"      # all | dots — 'dots' saves matmul
    #   outputs (jax.checkpoint dots_saveable policy): less recompute at
    #   higher live memory (a §Perf knob)
    unroll: bool = False           # python loops instead of lax.scan —
    #   used by the dry-run's cost CALIBRATION (XLA cost_analysis counts
    #   scan bodies once, not × trip count; see dryrun.py)
    citation: str = ""

    # ------------------------------------------------------------------ api
    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head",
                               self.d_model // max(self.n_heads, 1))
        if self.attn_impl == "mla" and self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.nope_head_dim)
        if self.n_experts and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.block_pattern in ("ssm", "zamba") and self.ssm_heads == 0:
            object.__setattr__(
                self, "ssm_heads",
                self.ssm_expand * self.d_model // self.ssm_headdim)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """True if a 500k-token decode is admissible (constant or windowed
        per-token state): SSM/hybrid natively, attention only when windowed."""
        if self.block_pattern == "ssm":
            return True
        if self.block_pattern == "zamba":
            # shared attn layers still need a window for 500k
            return self.sliding_window is not None
        return self.sliding_window is not None

    def mixer_kind(self, i: int) -> str:
        """Sequence-mixer of layer i: 'attn' or 'ssm'."""
        if self.block_pattern == "attn":
            return "attn"
        return "ssm"        # zamba's shared attn is *extra*, not a mixer swap

    def ffn_kind(self, i: int) -> str:
        if self.n_experts and i >= self.first_dense_layers:
            return "moe"
        if self.d_ff == 0 or self.block_pattern in ("ssm", "zamba"):
            # mamba2/zamba2: the SSM mixer is the whole block; zamba's d_ff
            # feeds the shared attention block's MLP instead
            return "none"
        return "dense"

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant: ≤2 layers (plus shared-attn period
        shrunk so the hybrid path is still exercised), d_model ≤ 512,
        ≤4 experts, small vocab — runs a fwd/train step on 1 CPU core."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if n_heads else 0
        updates = dict(
            name=self.name + "-smoke",
            n_layers=2 if self.block_pattern != "zamba" else 4,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=d_model // n_heads if n_heads else 32,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            remat=False,
            dtype="float32",
        )
        if self.n_experts:
            updates.update(n_experts=4, top_k=min(self.top_k, 2),
                           moe_d_ff=min(self.moe_d_ff or self.d_ff, 256),
                           first_dense_layers=min(self.first_dense_layers, 1))
        if self.attn_impl == "mla":
            updates.update(q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
                           nope_head_dim=32, v_head_dim=32)
        if self.block_pattern in ("ssm", "zamba"):
            updates.update(ssm_state=min(self.ssm_state, 16), ssm_headdim=32,
                           ssm_heads=2 * d_model // 32, ssm_chunk=16,
                           shared_attn_period=2)
        if self.modality == "vlm":
            updates.update(vis_tokens=min(self.vis_tokens, 16))
        return dataclasses.replace(self, **updates)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for i in range(L):
            fk = self.ffn_kind(i)
            per_layer += d if fk == "none" else 2 * d  # norms
            if self.parallel_block:
                per_layer -= d                         # single shared norm
            if self.mixer_kind(i) == "attn":
                per_layer += self._attn_params()
            else:
                per_layer += self._ssm_params()
            if fk == "none":
                pass
            elif fk == "dense":
                per_layer += 3 * d * self.d_ff
            else:
                per_layer += d * self.n_experts        # router
                per_layer += self.n_experts * 3 * d * self.moe_d_ff
                per_layer += self.n_shared_experts * 3 * d * self.d_ff
                if self.dense_residual:
                    per_layer += 3 * d * self.d_ff
        if self.block_pattern == "zamba":
            # one shared attn+MLP block (2 norms)
            per_layer += self._attn_params() + 3 * d * self.d_ff + 2 * d
        return emb + per_layer + d                     # final norm

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb + d
        for i in range(L):
            fk = self.ffn_kind(i)
            total += d if fk == "none" else 2 * d
            if self.parallel_block:
                total -= d
            total += (self._attn_params() if self.mixer_kind(i) == "attn"
                      else self._ssm_params())
            if fk == "none":
                pass
            elif fk == "dense":
                total += 3 * d * self.d_ff
            else:
                total += d * self.n_experts
                total += self.top_k * 3 * d * self.moe_d_ff
                total += self.n_shared_experts * 3 * d * self.d_ff
                if self.dense_residual:
                    total += 3 * d * self.d_ff
        if self.block_pattern == "zamba":
            total += self._attn_params() + 3 * d * self.d_ff + 2 * d
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_impl == "mla":
            qdim = self.n_heads * (self.nope_head_dim + self.rope_head_dim)
            p = d * self.q_lora_rank + self.q_lora_rank * qdim
            p += d * (self.kv_lora_rank + self.rope_head_dim)
            p += self.kv_lora_rank * self.n_heads * (self.nope_head_dim
                                                     + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            p += self.q_lora_rank + self.kv_lora_rank   # latent RMS norms
            return p
        h = self.n_heads * self.d_head
        hkv = self.n_kv_heads * self.d_head
        p = d * h + 2 * d * hkv + h * d
        if self.attn_bias:
            p += h + 2 * hkv + d
        if self.qk_norm:
            p += 2 * self.d_head
        return p

    def _ssm_params(self) -> int:
        di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
        in_proj = self.d_model * (2 * di + 2 * N + H)
        conv = (di + 2 * N) * (self.ssm_conv + 1)       # weights + bias
        return in_proj + conv + 3 * H + di + di * self.d_model  # + gated norm
