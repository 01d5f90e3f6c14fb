"""The kernels' operation and byte counts against hand arithmetic."""

from __future__ import annotations

import pytest

from h100_bench import counts


def test_k1_at_the_serving_w32_shape():
    # q (64, 128, 32*32), ctx (64, 64, 48, 32*32): B=4 avatars x 16 views
    B, D, S, Cc, Ci = 64, 48, 1024, 64, 128
    flops, nbytes = counts.k1_cost(B, D, S, Cc, Ci)
    proj = 2 * 64 * 48 * 1024 * 64 * 64            # Cc x Cc projection
    kv = 2 * 2 * 64 * 48 * 1024 * 64 * 128         # k and v
    attn = 2 * 2 * 64 * 48 * 1024 * 128            # logits and weighted sum
    assert flops == proj + kv + attn
    q = out = 64 * 128 * 1024 * 2
    ctx = 64 * 64 * 48 * 1024 * 2
    weights = (64 * 64 + 2 * 128 * 64) * 2
    affine = 2 * 64 * 64 * 4
    assert nbytes == q + out + ctx + weights + affine


def test_k2_at_the_serving_shape():
    # 4 avatars x 16 views x 2 (CFG) sequences of 1024 tokens, 8 heads of 40
    flops, nbytes = counts.k2_cost(128, 1024, 8, 40)
    assert flops == 2 * (2 * 128 * 8 * 1024 * 1024 * 40)
    assert nbytes == 4 * (128 * 1024 * 320 * 2) + 128 * 8 * 1024 * 4


def test_k2_backward_pair():
    f_dkv, b_dkv = counts.k2_dkv_cost(8, 1024, 8, 40)
    f_dq, b_dq = counts.k2_dq_cost(8, 1024, 8, 40)
    unit = 2 * 8 * 8 * 1024 * 1024 * 40
    assert (f_dkv, f_dq) == (4 * unit, 3 * unit)
    tok = 8 * 1024 * 320 * 2
    assert b_dkv == 6 * tok + 2 * 8 * 8 * 1024 * 4
    assert b_dq == 5 * tok + 2 * 8 * 8 * 1024 * 4


def test_k4_bf16_with_shift_and_fp32():
    flops, nbytes = counts.k4_cost(128, 320, 1024, 2, 2)
    assert flops == 8 * 128 * 320 * 1024
    assert nbytes == 2 * 128 * 320 * 1024 * 2 + 128 * 320 * 2 + 320 * 8
    assert counts.k4_cost(8, 64, 4096, 4, 0)[1] == 2 * 8 * 64 * 4096 * 4 + 64 * 8


def test_bounds_follow_the_launch_arguments():
    # group_norm: 5 pointers, B, C, G, S, pack, cluster, chunk, held, vec,
    # eps, act, dtype, shift dtype (the stream is dropped by the recorder)
    args = (1, 2, 3, 4, 5, 128, 320, 32, 1024, 1, 1, 1, 1, 1, 1e-5, 1, 1, 2)
    f, b = counts.k4_cost(128, 320, 1024, 2, 2)
    assert counts.launch_bound_s("group_norm", args) == pytest.approx(
        max(f / counts.PEAK_FP32, b / counts.PEAK_BYTES))
    fa = (1, 2, 3, 4, 5, 128, 1024, 8, 40, 40 ** -0.5)
    f, b = counts.k2_cost(128, 1024, 8, 40)
    assert counts.launch_bound_s("flash_attention", fa) == pytest.approx(
        max(f / counts.PEAK_BF16, b / counts.PEAK_BYTES))
    k1 = (0,) * 8 + (64, 48, 1024, 64, 128, 4, 2, 0.125)
    f, b = counts.k1_cost(64, 48, 1024, 64, 128)
    assert counts.launch_bound_s("depth_attention_ctx_wgmma", k1) == pytest.approx(
        max(f / counts.PEAK_BF16, b / counts.PEAK_BYTES))
