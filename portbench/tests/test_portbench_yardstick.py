"""The benchmark's frozen yardsticks against values worked out by hand."""
from __future__ import annotations

import pytest

from portbench import yardstick as Y


@pytest.mark.parametrize("args, kw, want", [
    # causal S = T = 4, 2 heads over 1 kv head, q/k 8 wide, v 4: bytes
    # 2 * 12 * (4 * 2 + 4 * 1); 10 pairs, 2 * 12 FLOP a pair and head
    ((1, 4, 2, 1, 8), dict(dv=4), (288, 480)),
    # non-causal 3 queries over 5 keys, B 2, 4 over 2 heads of 16
    ((2, 3, 4, 2, 16), dict(T=5, causal=False), (2816, 7680)),
    # causal with more queries than keys: 6 + 2 * 3 pairs
    ((1, 5, 1, 1, 2), dict(T=3), (2 * 4 * (5 + 3), 2 * 4 * 12)),
])
def test_k5_work_by_hand(args, kw, want):
    assert Y.k5_work(*args, **kw) == want


DENSE = dict(family="dense", d_model=4, n_heads=2, n_kv_heads=1, head_dim=2,
             d_ff=3, vocab=10, n_layers=2)
MOE = dict(family="moe", d_model=4, n_heads=2, n_kv_heads=2, head_dim=2,
           d_ff=3, vocab=10, n_layers=3, n_experts=4, top_k=2,
           n_shared_experts=1, d_expert=3, first_dense=1, d_ff_dense=5)
MLA = dict(family="mla", d_model=4, n_heads=2, n_kv_heads=2, d_ff=3,
           vocab=10, n_layers=1, q_lora=3, kv_lora=2, nope_dim=2, rope_dim=1,
           v_head_dim=2)


@pytest.mark.parametrize("m, want", [
    # head 40; a layer 48 of attention and 36 of SwiGLU
    (DENSE, 40 + 2 * (48 + 36)),
    # head 40; the dense layer 64 + 60; a MoE layer 64 + router 16 + 3
    # experts (2 routed, 1 shared) of 36
    (MOE, 40 + (64 + 60) + 2 * (64 + 16 + 108)),
    # head 40; wdq 12, wuq 18, wdkv 8, wkr 4, wuk and wuv 16, wo 16; 36
    (MLA, 40 + 74 + 36),
])
def test_matmul_params_by_hand(m, want):
    assert Y.matmul_params_per_token(m) == want


def test_model_flops_by_hand():
    # dense at B 1 x 4: 2 * 208 * 4 products, 2 layers of 160 attention
    assert Y.prefill_flops(DENSE, 1, 4) == 1664 + 320
    assert Y.train_flops(DENSE, 1, 4) == 3 * (1664 + 320)
    # MLA attends at q/k 3 wide, v 2: 10 pairs, 2 heads, 2 * 5 FLOP each
    assert Y.attention_flops(MLA, 1, 4) == 2 * 5 * 2 * 10


def test_k5_bound_is_the_larger_term():
    m = dict(DENSE, n_heads=32, n_kv_heads=8, head_dim=64)
    nbytes, flops = Y.k5_call(m, 1, 4096)
    assert Y.k5_bound_s(m, 1, 4096) == max(flops / 989e12, nbytes / 3.35e12)
    # PERF.md's K5 row at this shape: 0.069501 ms, bound by operations
    assert abs(Y.k5_bound_s(m, 1, 4096) * 1e3 - 0.069501) < 1e-6
