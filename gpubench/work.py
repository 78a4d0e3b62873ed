"""Operations and bytes the benchmark's work needs, from the shapes alone.

Nothing here depends on how a kernel tiles its work: causal attention
is counted over the ``T (T + 1) / 2`` query-key pairs each head needs,
each input is read once and each output written once, and recomputation
is not counted. A matrix product of ``m x k`` by ``k x n`` is ``2 m k
n`` operations.
"""

from __future__ import annotations

# bytes of one element
BF16, F32, I8 = 2, 4, 1


def lm_matmul_params(cfg: dict) -> int:
    """Parameters of the LM's matrix products per token, the vocab head
    included (the embedding is a lookup, not a product)."""
    D, H, L, V = (cfg[k] for k in ("d_model", "num_heads", "num_layers",
                                   "vocab_size"))
    Hk = cfg.get("num_kv_heads") or H
    hd = D // H
    F = cfg.get("mlp_ratio", 4) * D
    per_layer = D * H * hd + D * 2 * Hk * hd + H * hd * D + 2 * D * F
    return L * per_layer + D * V


def causal_pairs(T: int) -> int:
    return T * (T + 1) // 2


def causal_attn_train(cfg: dict, B: int, T: int) -> dict:
    """One training step's causal attention, every layer: forward (two
    products, ``q k^T`` and ``p v``) and backward (four: ``dp = do v^T``,
    ``dv = p^T do``, ``dq = ds k``, ``dk = ds^T q``), each ``2 hd``
    operations a pair and head. Bytes: the forward reads q, k, v and
    writes o and the f32 log-sum-exp; the backward reads q, k, v, o, do
    and the log-sum-exp and writes dq, dk, dv (bf16 tensors of ``B T H
    hd``; k and v at the query heads, as the kernels take them)."""
    D, H, L = cfg["d_model"], cfg["num_heads"], cfg["num_layers"]
    hd = D // H
    pairs = B * H * causal_pairs(T)
    act = B * T * H * hd * BF16
    lse = B * H * T * F32
    flops = L * 6 * 2 * hd * pairs
    nbytes = L * ((3 * act + act + lse) + (5 * act + lse + 3 * act))
    return {"flops": float(flops), "bytes": float(nbytes)}


def lm_train_step_flops(cfg: dict, B: int, T: int) -> float:
    """One training step: ``6 x matmul params x tokens`` (2 forward + 4
    backward operations a multiply-add) plus the causal attention's."""
    return (6.0 * lm_matmul_params(cfg) * B * T
            + causal_attn_train(cfg, B, T)["flops"])


def cnn_forward_flops(cfg: dict) -> float:
    """One sample's forward: ``2 H W Cin Cout 9`` a 3x3 convolution at its
    block's resolution, and the two dense products."""
    H, W, cin = cfg["input_shape"]
    fwd = 0
    for w in cfg["widths"]:
        for _ in range(2):
            fwd += 2 * H * W * cin * w * 9
            cin = w
        H, W = H // 2, W // 2
    fwd += 2 * H * W * cin * cfg["dense"] + 2 * cfg["dense"] * cfg[
        "num_classes"]
    return float(fwd)


def cnn_train_step_flops(cfg: dict, B: int) -> float:
    """One training step: the forward and a backward of twice its
    products, ``3 x`` the forward. ReLU, pooling, the loss and the
    optimizer are not counted."""
    return 3.0 * cnn_forward_flops(cfg) * B


def serve_position_flops(cfg: dict, ctx: int, head: bool) -> float:
    """Forward operations of one served position attending over ``ctx``
    positions (itself included): the matrix products, the attention's
    two products over ``ctx`` keys at every query head, and the vocab
    head where the position's logits are taken."""
    D, H, L, V = (cfg[k] for k in ("d_model", "num_heads", "num_layers",
                                   "vocab_size"))
    hd = D // H
    dense = lm_matmul_params(cfg) - D * V
    return (2.0 * dense + L * 4.0 * H * hd * ctx
            + (2.0 * D * V if head else 0.0))


def serve_attn_call(cfg: dict, fed: int, ctx_end: int,
                    kv_bytes: int = I8) -> dict:
    """One row of one attention call over a paged cache: ``fed`` query
    positions ending at context ``ctx_end``, every layer. Operations:
    two products over each query's causal context; bytes: the context's
    keys and values read once (``kv_bytes`` an element, plus an f32
    scale a token and KV head when quantized), the queries read and the
    outputs written in bf16."""
    D, H, L = cfg["d_model"], cfg["num_heads"], cfg["num_layers"]
    Hk = cfg.get("num_kv_heads") or H
    hd = D // H
    start = ctx_end - fed
    pairs = fed * start + causal_pairs(fed)
    kv = 2 * ctx_end * Hk * (hd * kv_bytes + (F32 if kv_bytes == I8 else 0))
    qo = 2 * fed * H * hd * BF16
    return {"flops": float(L * 4 * H * hd * pairs),
            "bytes": float(L * (kv + qo))}


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes: float) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes)
