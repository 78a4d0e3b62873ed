"""Plain reference of the flagship decoder LM.

Pre-norm blocks: LayerNorm (eps 1e-6) -> causal self-attention (query
heads over grouped key/value heads, each KV head serving H/Hk
consecutive query heads; rotary positions, rotate-half, theta 10000, on
queries and keys) -> residual; LayerNorm -> Dense(4D) -> GELU (tanh
form) -> Dense(D) -> residual; a final LayerNorm and an untied vocab
head with bias. Weights are ``gpubench.weights.lm_specs`` leaves. The
training objective is the mean next-token cross-entropy over every
position but each row's last.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference.precision import F32

_LN_EPS = 1e-6


def layer_norm(x, scale, bias):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + _LN_EPS) * scale + bias


def rope(x, pos):
    """Rotate-half rotary embedding of ``x [b, T, h, hd]`` at ``pos [T]``."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    ang = pos.to(torch.float32)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def features(w, tokens, cfg, prec=F32):
    """The final LayerNorm's output ``[b, T, D]`` of ``tokens [b, T]``."""
    D, H, L = cfg["d_model"], cfg["num_heads"], cfg["num_layers"]
    Hk = cfg.get("num_kv_heads") or H
    hd = D // H
    b, T = tokens.shape
    pos = torch.arange(T, device=tokens.device)
    causal = torch.ones((T, T), dtype=torch.bool,
                        device=tokens.device).tril()
    x = w["embed.embedding"][tokens]
    for i in range(L):
        p = f"blocks.{i}."
        a = p + "CausalSelfAttention_0."
        h = layer_norm(x, w[p + "LayerNorm_0.scale"], w[p + "LayerNorm_0.bias"])
        q = (prec.mm(h, w[a + "q_proj.kernel"].reshape(D, H * hd))
             + w[a + "q_proj.bias"].reshape(-1)).view(b, T, H, hd)
        kv = (prec.mm(h, w[a + "kv_proj.kernel"].reshape(D, 2 * Hk * hd))
              + w[a + "kv_proj.bias"].reshape(-1)).view(b, T, 2, Hk, hd)
        q, k, v = rope(q, pos), rope(kv[:, :, 0], pos), kv[:, :, 1]
        k = k.repeat_interleave(H // Hk, dim=2)
        v = v.repeat_interleave(H // Hk, dim=2)
        s = prec.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o = prec.mm(torch.softmax(s, dim=-1), v.transpose(1, 2))
        o = o.transpose(1, 2).reshape(b, T, H * hd)
        x = x + prec.mm(o, w[a + "out.kernel"].reshape(H * hd, D)) \
            + w[a + "out.bias"]
        h = layer_norm(x, w[p + "LayerNorm_1.scale"], w[p + "LayerNorm_1.bias"])
        u = F.gelu(prec.mm(h, w[p + "mlp_up.kernel"]) + w[p + "mlp_up.bias"],
                   approximate="tanh")
        x = x + prec.mm(u, w[p + "mlp_down.kernel"]) + w[p + "mlp_down.bias"]
    return layer_norm(x, w["ln_f.scale"], w["ln_f.bias"])


def logits(w, tokens, cfg, prec=F32):
    """``[b, T, V]`` f32 logits of ``tokens [b, T]``."""
    return prec.mm(features(w, tokens, cfg, prec), w["head.kernel"]) \
        + w["head.bias"]


def loss_sum(w, tokens, cfg, prec=F32):
    """Summed next-token cross-entropy of ``tokens [b, T]`` over every
    position but each row's last, and the number of positions summed."""
    out = logits(w, tokens, cfg, prec)
    V = out.shape[-1]
    ce = F.cross_entropy(out[:, :-1].reshape(-1, V),
                         tokens[:, 1:].reshape(-1), reduction="sum")
    return ce, tokens.shape[0] * (tokens.shape[1] - 1)
