"""The work counts against hand counts at small shapes."""

import pytest

from gpubench import work

# D=4, H=2 (hd 2), Hk=1, L=1, V=10, 4x MLP
SMALL = dict(d_model=4, num_heads=2, num_kv_heads=1, num_layers=1,
             vocab_size=10, mlp_ratio=4)


def test_lm_matmul_params_by_hand():
    # q 4*2*2 + kv 4*2*1*2 + out 2*2*4 + mlp 2*4*16, head 4*10
    assert work.lm_matmul_params(SMALL) == 16 + 16 + 16 + 128 + 40


def test_causal_attention_by_hand():
    # T=3: 6 query-key pairs a head; B=1, H=2: 12 pairs; six products of
    # 2 hd = 4 operations a pair
    w = work.causal_attn_train(SMALL, B=1, T=3)
    assert w["flops"] == 12 * 6 * 4
    act = 1 * 3 * 2 * 2 * 2  # B T H hd bf16
    lse = 1 * 2 * 3 * 4
    assert w["bytes"] == (4 * act + lse) + (8 * act + lse)


def test_train_step_flops_by_hand():
    B, T = 2, 3
    assert work.lm_train_step_flops(SMALL, B, T) == (
        6 * 216 * B * T + work.causal_attn_train(SMALL, B, T)["flops"])


def test_counts_do_not_follow_the_kernels_tile(monkeypatch):
    """The count is from the shapes: the port's attention block size
    moves nothing."""
    from distkeras_torch.ops import pallas_attention as fa

    cfg = dict(SMALL, d_model=2048, num_heads=8, num_kv_heads=2,
               num_layers=8, vocab_size=8192)
    before = work.lm_train_step_flops(cfg, 8, 2048)
    monkeypatch.setattr(fa, "BLOCK", 128)
    assert work.lm_train_step_flops(cfg, 8, 2048) == before
    # the flagship's step: 6 x 369.1M x 16384 + 3.30 TFLOP of attention
    assert before == pytest.approx(39.584e12, rel=1e-4)


def test_cnn_by_hand():
    cfg = dict(widths=[2], dense=3, num_classes=2, input_shape=[4, 4, 1])
    # conv 2*16*1*2*9 + conv 2*16*2*2*9 at 4x4, then 2x2x2 -> dense 3 -> 2
    fwd = 2 * 16 * 1 * 2 * 9 + 2 * 16 * 2 * 2 * 9 + 2 * 8 * 3 + 2 * 3 * 2
    assert work.cnn_forward_flops(cfg) == fwd
    assert work.cnn_train_step_flops(cfg, 5) == 3 * fwd * 5


def test_serving_attention_call_by_hand():
    # 2 fed positions ending at context 5: pairs 2*3 + 3 = 9
    cfg = dict(SMALL)
    c = work.serve_attn_call(cfg, fed=2, ctx_end=5)
    assert c["flops"] == 1 * 4 * 2 * 2 * 9
    kv = 2 * 5 * 1 * (2 * 1 + 4)  # int8 values + f32 scales
    assert c["bytes"] == kv + 2 * 2 * 2 * 2 * 2
    assert work.least_seconds(10.0, 4.0, 5.0, 1.0) == 4.0
