"""The benchmark's frozen yardsticks: the H100's datasheet peaks, the
operations and bytes of one call of the flash-attention kernel (K5), and
the model FLOPs of a training step or a prefill, all worked out from a
configuration's sizes (the ``model`` group of a file under
``portbench/configs/``).

These are copies kept with the benchmark, so that a change to the
program never changes the measure: K5's count is
``repro_torch/kernels/flash_attention.py::work``, the peaks are
``repro_torch/launch/mesh.py``'s.  Nothing here imports the program.
"""
from __future__ import annotations

# NVIDIA H100 SXM datasheet, dense, per card, at its 700 W power limit
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12    # bytes/s, HBM3


def k5_work(B, S, H, Hk, dh, *, T=None, dv=None, causal=True,
            nbytes_el=2) -> tuple[int, int]:
    """(bytes, FLOPs) of one K5 call, S queries over T keys (T = S unless
    given): q and o read and written over S, k and v over T, once each (q,
    k dh wide, v and o dv wide); 2 (dh + dv) FLOP per visible (query, key)
    pair and head.  Causal (top-left) query s sees min(s + 1, T) keys,
    S (S + 1) / 2 pairs at S == T; a non-causal call sees S T."""
    dv = dh if dv is None else dv
    T = S if T is None else T
    nbytes = nbytes_el * B * (dh + dv) * (S * H + T * Hk)
    if not causal:
        pairs = S * T
    elif S <= T:
        pairs = S * (S + 1) // 2
    else:
        pairs = T * (T + 1) // 2 + (S - T) * T
    return nbytes, 2 * (dh + dv) * B * H * pairs


def attention_shape(m: dict) -> tuple[int, int, int, int]:
    """(H, Hk, dh, dv) of a layer's attention call: MLA attends over its
    expanded heads (q/k ``nope + rope`` wide, v ``v_head_dim``)."""
    if m["family"] == "mla":
        return (m["n_heads"], m["n_heads"], m["nope_dim"] + m["rope_dim"],
                m["v_head_dim"])
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    return m["n_heads"], m["n_kv_heads"], hd, hd


def k5_call(m: dict, B: int, S: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one layer's causal K5 call at B x S in bf16."""
    H, Hk, dh, dv = attention_shape(m)
    return k5_work(B, S, H, Hk, dh, dv=dv, causal=True)


def k5_bound_s(m: dict, B: int, S: int) -> float:
    """The least time one such call could take on the card: the larger of
    its FLOPs over the bf16 peak and its bytes over HBM's rate."""
    nbytes, flops = k5_call(m, B, S)
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def matmul_params_per_token(m: dict) -> int:
    """Weights a token meets in matrix products on its path: attention
    projections, the FFN (a MoE layer's router, its ``top_k`` routed and
    its shared experts), and the LM head over the real vocabulary.  The
    embedding lookup is no product."""
    d = m["d_model"]
    if m["family"] == "mla":
        H, qk = m["n_heads"], m["nope_dim"] + m["rope_dim"]
        attn = (d * m["q_lora"] + m["q_lora"] * H * qk
                + d * m["kv_lora"] + d * m["rope_dim"]
                + m["kv_lora"] * H * (m["nope_dim"] + m["v_head_dim"])
                + H * m["v_head_dim"] * d)
    else:
        H, Hk, hd, _ = attention_shape(m)
        attn = d * H * hd + 2 * d * Hk * hd + H * hd * d
    n_layers, first_dense = m["n_layers"], m.get("first_dense", 0)
    total = d * m["vocab"]
    if m["family"] == "moe":
        de = m["d_expert"]
        moe = d * m["n_experts"] + 3 * d * de * (m["top_k"]
                                                 + m["n_shared_experts"])
        dense = 3 * d * (m.get("d_ff_dense") or m["d_ff"])
        total += first_dense * (attn + dense)
        total += (n_layers - first_dense) * (attn + moe)
    else:
        total += n_layers * (attn + 3 * d * m["d_ff"])
    return total


def attention_flops(m: dict, B: int, S: int) -> int:
    return m["n_layers"] * k5_call(m, B, S)[1]


def prefill_flops(m: dict, B: int, S: int) -> float:
    """Model FLOPs of a causal forward over B x S tokens: 2 per weight a
    token meets in a product, and the attention's causal pairs."""
    return 2.0 * matmul_params_per_token(m) * B * S + attention_flops(m, B, S)


def train_flops(m: dict, B: int, S: int) -> float:
    """A training step's model FLOPs: the forward's, three times (forward,
    and the two products of each in the backward); no remat recompute."""
    return 3.0 * prefill_flops(m, B, S)
