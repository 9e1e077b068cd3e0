"""The yardstick: one H100's published peaks, the operations and bytes of
the port's two language-model kernels, and the model FLOPs of a step.

Frozen copies, so that a change to the program cannot move them:
  * the peaks are NVIDIA's data sheet for the H100 SXM at its 700 W power
    limit, dense rates (the values of ``repro_torch.launch.mesh``);
  * :func:`flash_cost` is ``repro_torch.kernels.flash_attention.cost``
    with :func:`visible_pairs`; :func:`ssd_cost` is
    ``repro_torch.kernels.ssd_scan.cost``; both from shapes and dtypes
    alone, so a reader needs no tensor;
  * :func:`bound_s` is ``chip_smoke.bound``: the least time, the larger
    of bytes over the HBM rate and operations over the peak.

Model FLOPs count the algorithm's matrix products and the attention and
SSD work it needs, once: a remat recompute is not model work.  Imports
nothing but the standard library.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12        # dense bf16 on the tensor cores, a card
PEAK_FLOPS_F32 = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12       # HBM3, a card

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def visible_pairs(Sq: int, Skv: int, window=None, causal: bool = True) -> int:
    """(query, key) pairs that the causal mask, aligned at the ends of
    both sequences, and the window leave visible: query i sees keys
    lo..hi, hi = min(i + Skv − Sq, Skv − 1) (causal), lo = max(i + Skv −
    Sq − window + 1, 0)."""
    total = 0
    for i in range(Sq):
        qp = i + Skv - Sq
        hi = min(qp, Skv - 1) if causal else Skv - 1
        lo = 0 if window is None else max(qp - window + 1, 0)
        total += max(hi - lo + 1, 0)
    return total


def flash_cost(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int, *,
               dtype: str = "bfloat16", window=None,
               causal: bool = True) -> tuple[int, int]:
    """(operations, bytes) of one ``flash_attention`` call: 4·D operations
    a visible pair and head (Q Kᵀ and P V), q, k, v read once and the
    output written once."""
    flops = 4 * D * B * H * visible_pairs(Sq, Skv, window, causal)
    item = ITEMSIZE[dtype]
    n_bytes = item * (2 * B * Sq * H * D + 2 * B * Skv * Hkv * D)
    return flops, n_bytes


def ssd_cost(B: int, S: int, H: int, P: int, N: int, *,
             dtype: str = "bfloat16",
             dt_dtype: str = "float32") -> tuple[int, int]:
    """(operations, bytes) of one ``ssd_scan`` call: 5·P·N operations a
    token and head (3 for the state update, 2 for the readout); x, dt,
    A, Bm, Cm, D read once, y and the float32 final state written once
    (A and D float32, as the wrapper passes them)."""
    item, dti = ITEMSIZE[dtype], ITEMSIZE[dt_dtype]
    n_bytes = (2 * item * B * S * H * P          # x read, y written
               + dti * B * S * H                 # dt
               + 2 * 4 * H                       # A, D
               + 2 * item * B * S * N            # Bm, Cm
               + 4 * B * H * P * N)              # h_final
    return 5 * B * S * H * P * N, n_bytes


def bound_s(flops: float, n_bytes: float,
            flop_per_s: float = PEAK_FLOPS_BF16) -> tuple[float, str]:
    """The least time a call can take on one card, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------------------------ model FLOPs

def block_matmul_params(model: dict) -> dict:
    """Parameters of the matrix products a token passes through, by part,
    from a configuration file's ``model`` block (the port's
    ``ModelConfig`` fields): ``mixer`` (every layer's attention or SSM
    projections), ``ffn`` (every layer's dense SwiGLU), ``head`` (the LM
    head)."""
    d, L = model["d_model"], model["n_layers"]
    out = {"head": d * model["vocab_size"]}
    if model.get("block_pattern", "attn") == "attn":
        H, Hkv = model["n_heads"], model["n_kv_heads"]
        Dh = model.get("d_head") or d // H
        out["mixer"] = L * (d * H * Dh + 2 * d * Hkv * Dh + H * Dh * d)
        out["ffn"] = L * 3 * d * model["d_ff"]
        return out
    if model["block_pattern"] != "ssm":
        raise ValueError(f"no model FLOPs for {model['block_pattern']!r}")
    di = model["ssm_expand"] * d
    N = model["ssm_state"]
    Hs = model.get("ssm_heads") or di // model["ssm_headdim"]
    out["mixer"], out["ffn"] = L * (d * (2 * di + 2 * N + Hs) + di * d), 0
    return out


def attention_flops(model: dict, B: int, S: int) -> int:
    """Forward operations of every attention core in a stack over B
    sequences of S tokens (4·D a visible pair and head)."""
    if model.get("block_pattern", "attn") != "attn":
        return 0
    d, H = model["d_model"], model["n_heads"]
    Dh = model.get("d_head") or d // H
    pairs = visible_pairs(S, S, model.get("sliding_window"))
    return 4 * Dh * H * B * pairs * model["n_layers"]


def ssd_flops(model: dict, B: int, S: int) -> int:
    """Forward operations of every SSD recurrence in a stack (5·P·N a
    token and head, :func:`ssd_cost`)."""
    if model.get("block_pattern", "attn") != "ssm":
        return 0
    di = model["ssm_expand"] * model["d_model"]
    P = model["ssm_headdim"]
    Hs = model.get("ssm_heads") or di // P
    return 5 * B * S * Hs * P * model["ssm_state"] * model["n_layers"]


def train_step_flops(model: dict, n_seqs: int, S: int) -> int:
    """Model FLOPs of one train step over ``n_seqs`` sequences of S
    tokens (every node's): 6 a matmul parameter and token (forward and
    both backward products), three times the attention and SSD forward
    work; the head over every position."""
    p = block_matmul_params(model)
    tokens = n_seqs * S
    return (6 * sum(p.values()) * tokens
            + 3 * attention_flops(model, n_seqs, S)
            + 3 * ssd_flops(model, n_seqs, S))


def prefill_flops(model: dict, B: int, S: int) -> int:
    """Model FLOPs of one prefill call of B prompts of S tokens: 2 a
    matmul parameter and token through the stack, the attention and SSD
    forward work, and the LM head at the last position only."""
    p = block_matmul_params(model)
    return (2 * (p["mixer"] + p["ffn"]) * B * S
            + attention_flops(model, B, S) + ssd_flops(model, B, S)
            + 2 * p["head"] * B)
