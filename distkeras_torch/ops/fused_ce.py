"""Fused (chunked) linear + softmax cross-entropy — the port of
:mod:`distkeras_tpu.ops.fused_ce`.

:func:`fused_linear_softmax_ce` computes the LM head's weighted
cross-entropy chunk by chunk over rows, as a ``torch.autograd.Function``:
the forward runs ``chunk x V`` logits through logsumexp and discards
them (saving only the inputs), and the backward recomputes each chunk's
logits, forms the softmax cotangent and consumes it at once in the
``dx``/``dkernel`` products. The ``[N, V]`` logits and their cotangent
never exist in device memory.

It is not a kernel in the reference either (a ``lax.scan`` over XLA
dots), so it is plain PyTorch. Numerics follow the reference: the
logits are model-dtype operands with f32 accumulation and an f32 result,
plus the f32 bias (``VocabHead``'s product); the backward casts the
softmax cotangent to the activation dtype before its two products; the
per-row weights get their gradient (the row's own cross-entropy).
"""

from __future__ import annotations

import torch

# rows per chunk: the backward's transient is chunk x V f32 logits
# (64 MB at the flagship's 8192-token vocab)
DEFAULT_CHUNK = 2048


def matmul_f32(a, b):
    """``a @ b`` for 2-D operands in the model dtype with f32
    accumulation and an f32 result (the reference's
    ``preferred_element_type=float32`` dot). On the card a reduced-
    precision pair goes to one cuBLAS call with an f32 output; on the
    host the operands are upcast, which is exact."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _logits(xc, kernel, bias, dtype):
    """One chunk's logits exactly as VocabHead computes them."""
    return matmul_f32(xc.to(dtype), kernel.to(dtype)) + bias


class _FusedLinearSoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias, labels, weights, chunk):
        N = x.shape[0]
        C = min(chunk, N)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, N, C):
            logits = _logits(x[c0:c0 + C], kernel, bias, x.dtype)
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, 1, labels[c0:c0 + C, None])[:, 0]
            total = total + torch.sum(weights[c0:c0 + C] * (lse - ll))
        ctx.save_for_backward(x, kernel, bias, labels, weights)
        ctx.chunk = C
        return total

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias, labels, weights = ctx.saved_tensors
        C = ctx.chunk
        N = x.shape[0]
        km = kernel.to(x.dtype)
        dk = torch.zeros(kernel.shape, dtype=torch.float32, device=x.device)
        db = torch.zeros(bias.shape, dtype=torch.float32, device=x.device)
        dxs, dws = [], []
        for c0 in range(0, N, C):
            xc = x[c0:c0 + C]
            lc = labels[c0:c0 + C]
            # recompute this chunk's logits, then the softmax cotangent
            logits = _logits(xc, kernel, bias, x.dtype)
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, 1, lc[:, None])[:, 0]
            scale = (weights[c0:c0 + C] * g)[:, None]
            dl = torch.softmax(logits, dim=-1) * scale
            dl = dl.scatter_add(1, lc[:, None], -scale)  # - scale * one_hot
            # both consuming products: activation-dtype operands, f32
            # accumulation, like the forward
            dlc = dl.to(x.dtype)
            dxs.append(matmul_f32(dlc, km.t()).to(x.dtype))
            dk = dk + matmul_f32(xc.to(x.dtype).t(), dlc)
            db = db + dl.sum(dim=0)
            # d loss / d weights[i] is the row's own cross-entropy
            dws.append((lse - ll) * g)
        dx = torch.cat(dxs, dim=0) if N else torch.zeros_like(x)
        dw = torch.cat(dws, dim=0).to(weights.dtype)
        return dx, dk.to(kernel.dtype), db.to(bias.dtype), None, dw, None


def fused_linear_softmax_ce(x, kernel, bias, labels, weights,
                            chunk: int = DEFAULT_CHUNK):
    """``sum_i weights[i] * CE(softmax(x[i] @ kernel + bias), labels[i])``
    without materializing the ``[N, V]`` logits.

    Args:
      x: ``[N, D]`` activations (bf16 in the flagship).
      kernel: ``[D, V]`` f32 head weights (cast to ``x.dtype`` for the
        product, f32 accumulation — identical to ``VocabHead``).
      bias: ``[V]`` f32.
      labels: ``[N]`` int64 target ids.
      weights: ``[N]`` f32 per-row weights (0 masks a row out; the caller
        divides by its own count).
      chunk: rows per chunk.

    Returns the scalar f32 weighted sum of per-row cross-entropies.
    """
    return _FusedLinearSoftmaxCE.apply(x, kernel, bias, labels.long(),
                                       weights, chunk)


def lm_head_loss(features, head_params, targets, mask,
                 chunk: int = DEFAULT_CHUNK):
    """Flagship-LM wrapper: ``features`` ``[B, T, D]`` (the backbone's
    ``ln_f`` output), ``head_params`` the head's ``{'kernel': [D, V],
    'bias': [V]}``, ``targets`` ``[B, T]`` ids, ``mask`` ``[B, T]`` row
    weights. Returns ``(sum, count)``; the caller divides."""
    B, T, D = features.shape
    s = fused_linear_softmax_ce(
        features.reshape(B * T, D), head_params["kernel"],
        head_params["bias"], targets.reshape(B * T),
        mask.reshape(B * T).to(torch.float32), chunk)
    return s, torch.sum(mask)
