"""TransformerLM — the port of :mod:`distkeras_tpu.models.transformer`.

A pre-norm decoder-only transformer with the reference's parameter tree
(module and parameter names mirror the flax tree, so
:mod:`distkeras_torch.bridge` maps weights both ways by name) and its
decode paths for the serving engine, and its training-mode attention:

- **slot cache** (``decode=True``, scalar or per-slot cursors): K/V
  written at each row's cursor, attended with a positions-seen-so-far
  mask — dense for one-token steps, the splash chunked-prefill kernel
  (:mod:`distkeras_torch.ops.splash_prefill`) for chunks;
- **paged cache** (``decode=True, paged=True``): K/V scattered into a
  pool of fixed-size blocks through per-row block tables, attended by
  the paged-attention kernel (:mod:`distkeras_torch.ops.paged_attention`)
  or the gathered reference;
- ``valid_lens`` chunk semantics: row ``b`` consumes only its first
  ``valid_lens[b]`` tokens; padding writes are dropped (slot) or land in
  the reserved trash block 0 (paged), so chunked prefill leaves the same
  cache bytes as a monolithic one;
- non-decode attention (training, full-sequence scoring): ``'dense'``
  up to ``T=512``; above it ``'standard'`` takes the hand-written causal
  flash-attention kernels (:mod:`distkeras_torch.ops.pallas_attention`)
  where their ``preferred()`` gate passes, else the blocked plain
  PyTorch op (:mod:`distkeras_torch.ops.flash_attention`);
  ``remat='block'`` recomputes each block in the backward
  (``torch.utils.checkpoint``);
- sequence parallelism: ``attention='ring'`` runs inside a bound mesh
  (``with mesh:``, as the LM step binds it), each rank holding a
  ``T/sp`` shard of the sequence: attention is the zigzag ring over the
  mesh's ``seq_axis`` group (:mod:`distkeras_torch.ops.ring_attention`,
  whose chunk pairs go through the hand-written pair kernels on CUDA),
  and positions (rope or sinusoidal) are GLOBAL, offset by the shard
  index times ``T/sp``.

Every parameter is stored in f32 whatever the model dtype, as flax
stores it, and cast to the model dtype at each use: autograd then gives
f32 gradients of f32 master weights, as ``jax.value_and_grad`` does,
and the weight bridge round-trips exactly.

PyTorch idiom around the JAX design: parameters live in the module (not
a separate tree), the decode cache is an explicit :class:`KVCache`
updated in place (JAX threads a functional ``cache`` collection through
``apply``), and ``clone(**overrides)`` gives a twin that SHARES the
parameters — flax's ``model.clone(decode=True)`` over one param tree.
Every random draw takes an explicit ``torch.Generator``.

Numerics follow the reference exactly where it matters for parity:
flax ``nn.gelu`` is the tanh approximation, flax ``LayerNorm`` uses
eps=1e-6 with f32 statistics, rope is computed in f32, masks fill
``-1e30``, probabilities are cast to the model dtype before the PV
product, and the vocab head takes model-dtype operands with f32
accumulation and f32 logits.

Decoding: :func:`generate` (greedy or sampled with a per-call
``torch.Generator``) and :func:`beam_search`.

Tensor parallelism (``tp_size > 1``, Megatron-style, the reference's
``TPDenseGeneral`` modes): each tp rank is one process holding its own
slice of the heads and of the MLP hidden dimension — ``qkv`` /
``q_proj`` / ``kv_proj`` and ``mlp_up`` column-parallel, ``out`` and
``mlp_down`` row-parallel, one ``all_reduce`` per col -> row pair
(:mod:`distkeras_torch.parallel.collectives`). Rank ``r`` holds heads
``[r H/tp, (r+1) H/tp)`` and KV heads ``[r Hk/tp, (r+1) Hk/tp)``, so the
GQA grouping is the same on every rank. The rank is read from the mesh
bound by ``with mesh:`` when the model is built (and its ``tp_axis``
group when it runs); a ``tp_size=n`` model built from a seed holds
exactly the slices of the ``tp_size=1`` model built from that seed.

Mixture of experts (``moe_experts > 0``, :class:`MoeLM`): each block's
dense MLP becomes a top-``moe_top_k`` routed bank of experts
(:class:`~distkeras_torch.ops.moe.SwitchMoE`, parameters under ``moe``),
sharded over the bound mesh's ``ep_axis`` when ``ep_size > 1`` (an ep
model is built and run inside ``with mesh:``, like a tp model, and holds
exactly the expert slices of the ``ep_size=1`` model from the same
seed). ``model(tokens, return_aux=True)`` returns ``(out, auxes)``, one
Switch load-balancing loss per MoE layer in the graph (empty for a dense
model), which the MoE step adds to its objective.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from distkeras_torch.models.registry import register_model
from distkeras_torch.ops.moe import SwitchMoE
from distkeras_torch.ops import paged_attention as _pa
from distkeras_torch.ops import pallas_attention as _fa
from distkeras_torch.ops import splash_prefill as _sp
from distkeras_torch.ops.flash_attention import blocked_causal_attention
from distkeras_torch.ops.ring_attention import ring_attention
from distkeras_torch.parallel.collectives import copy_to_tp, reduce_from_tp
from distkeras_torch.parallel.mesh import current_mesh
from distkeras_torch.utils.device import resolve_device

_NEG_INF = -1e30
_LN_EPS = 1e-6  # flax LayerNorm's default epsilon
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def apply_rope(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding (rotate-half convention, theta=10000):
    ``x [B, T, H, hd]`` rotated by per-position angles computed in f32
    and cast back to ``x.dtype``. ``pos`` are GLOBAL positions: ``[T]``
    shared across the batch, or ``[B, T]`` per row."""
    hd = x.shape[-1]
    if hd % 2:
        raise ValueError(
            f"rope needs an even head dim (pairs of rotated channels); "
            f"got head_dim={hd} — pick d_model/num_heads even"
        )
    half = hd // 2
    freqs = 1.0 / (10000.0 ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = pos.to(torch.float32)[..., None] * freqs  # [(B,) T, half]
    if ang.dim() == 3:
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
    else:
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _ring_shard(cfg):
    """(sequence group, shard index) of a ``'ring'`` model: the bound
    mesh's ``cfg.seq_axis`` group and this rank's coordinate on it."""
    mesh = current_mesh()
    if mesh is None or cfg.seq_axis not in mesh.axis_names:
        raise ValueError(
            f"attention='ring' shards the sequence over the '{cfg.seq_axis}' "
            f"axis of a bound mesh: call the model inside `with "
            f"make_mesh({{'dp': ..., '{cfg.seq_axis}': ...}}):`, or train it "
            f"through make_lm_train_step(mesh=...)")
    return mesh.group(cfg.seq_axis), mesh.index(cfg.seq_axis)


def _sharding_mesh(axis: str, size: int, what: str, step: str):
    """The bound mesh a model sharded ``size`` ways over ``axis`` (its
    heads under tp, its experts under ep) is built and run in: that axis
    must be of size ``size``."""
    mesh = current_mesh()
    if (mesh is None or axis not in mesh.axis_names
            or mesh.axis_size(axis) != size):
        raise ValueError(
            f"{what}={size} shards over the '{axis}' axis of a bound mesh "
            f"of that size: build and call the model inside `with "
            f"make_mesh({{..., '{axis}': {size}}}):` (got {mesh!r}), or "
            f"train it through {step}")
    return mesh


def _tp_mesh(tp_axis: str, tp_size: int):
    return _sharding_mesh(tp_axis, tp_size, "tp_size",
                          f"make_lm_train_step(mesh=..., "
                          f"tp_axis='{tp_axis}')")


def _ep_mesh(ep_axis: str, ep_size: int):
    return _sharding_mesh(ep_axis, ep_size, "ep_size",
                          "make_moe_lm_train_step(mesh=...)")


def _tp_group(tp_axis: str, tp_size: int):
    """The tp process group of the bound mesh (None at tp_size=1)."""
    if tp_size == 1:
        return None
    return _tp_mesh(tp_axis, tp_size).group(tp_axis)


def remat_block(block, x, cfg):
    """flax ``nn.remat(Block)``: ``block(x, cfg)`` keeping only its input;
    its internals are recomputed in the backward. The recompute runs
    wherever autograd runs the backward: outside the step's ``with
    mesh:``, and on a card in autograd's own device thread, whose bound
    meshes are empty. So it rebinds the mesh bound at the forward, from
    which the block reads its tp, ep and sp groups."""
    mesh = current_mesh()

    def contexts():
        return (contextlib.nullcontext(),
                mesh if mesh is not None else contextlib.nullcontext())

    return checkpoint(block, x, cfg, use_reentrant=False, context_fn=contexts)


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    pos = np.arange(max_len)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.zeros((max_len, dim), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


def _quantize_int8(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization for the KV cache:
    ``[..., hd]`` -> (int8 values, f32 scales over the last axis)."""
    xf = x.to(torch.float32)
    a = xf.abs().amax(dim=-1)
    s = torch.clamp(a / 127.0, min=1e-8)
    qx = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return qx.to(torch.int8), s


def _write_kv(put, k, v, quant: bool):
    """Store one call's K/V through ``put(leaf_name, values)``: int8
    values plus f32 scales under ``cache_dtype='int8'``, else as they
    are."""
    if quant:
        kq, k_s = _quantize_int8(k)
        vq, v_s = _quantize_int8(v)
        put("key", kq)
        put("value", vq)
        put("key_scale", k_s)
        put("value_scale", v_s)
    else:
        put("key", k)
        put("value", v)


def _trunc_normal(shape, fan_in, device, gen):
    """flax ``variance_scaling(1.0, 'fan_in', 'truncated_normal')``, in
    f32."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return w


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: f32 statistics with the fast
    variance ``E[x^2] - E[x]^2`` (clipped at 0), eps=1e-6, f32 scale and
    bias, output cast to the model dtype. The parameters stay f32 even
    in a bf16 model, as flax keeps them."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + _LN_EPS) * self.scale
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: the f32 table cast to the model dtype, then a
    row lookup."""

    def __init__(self, num: int, dim: int, dtype, device, gen):
        super().__init__()
        self.dtype = dtype
        # flax default_embed_init: variance_scaling(1, 'fan_in', 'normal',
        # out_axis=0) over [num, dim] -> std sqrt(1 / num)
        w = torch.empty((num, dim), dtype=torch.float32, device=device)
        w.normal_(0.0, math.sqrt(1.0 / num), generator=gen)
        self.embedding = nn.Parameter(w)

    def forward(self, tokens):
        return F.embedding(tokens.long(), self.embedding.to(self.dtype))


class TPDenseGeneral(nn.Module):
    """Dense projection contracting the trailing ``len(in_shape)`` axes
    of ``x`` into ``features`` — the reference's ``TPDenseGeneral``.
    ``in_shape`` and ``features`` are the GLOBAL (``tp_size=1``) shapes;
    ``kernel`` keeps the flax shape ``in_shape + features`` of this
    rank's slice (so weights bridge by name) and is used as one
    ``[fan_in, out]`` matrix. Kernel and bias are f32 master weights,
    cast to the model dtype on every call as the reference casts them
    (a bf16 copy stored in their place would put the optimizer's
    updates on bf16 weights).

    With ``tp_size > 1``, rank ``tp_rank`` of the bound mesh's
    ``tp_axis`` holds, in ``mode='col'``, the contiguous ``1/tp`` slice
    of ``features[shard_dim]`` (its input is replicated: the caller puts
    :func:`~distkeras_torch.parallel.collectives.copy_to_tp` before it,
    once per input however many col layers read it); in ``mode='row'``
    the slice of ``in_shape[0]`` — its input is the col layer's local
    output, its partial products are summed over the tp group, and the
    replicated bias is added once, after the sum. The kernel is drawn
    at its full shape from ``gen`` and sliced, so a sharded layer holds
    exactly the slice of the unsharded layer drawn from the same
    generator state."""

    def __init__(self, in_shape, features, dtype, device, gen,
                 use_bias: bool = True, tp_size: int = 1,
                 mode: Optional[str] = None, shard_dim: int = 0,
                 tp_axis: str = "tp", tp_rank: Optional[int] = None):
        super().__init__()
        if mode not in (None, "col", "row"):
            raise ValueError(f"Unknown TPDenseGeneral mode '{mode}'. "
                             "Known: col, row")
        in_shape, features = tuple(in_shape), tuple(features)
        self.dtype = dtype
        self.tp_size, self.tp_axis = tp_size, tp_axis
        self.mode = mode if tp_size > 1 else None
        full = _trunc_normal(in_shape + features, int(np.prod(in_shape)),
                             device, gen)
        if self.mode is not None:
            if tp_rank is None:
                tp_rank = _tp_mesh(tp_axis, tp_size).index(tp_axis)
            dim = len(in_shape) + shard_dim if self.mode == "col" else 0
            n = full.shape[dim]
            if n % tp_size:
                raise ValueError(
                    f"{self.mode}-parallel dim {n} not divisible by "
                    f"tp_size={tp_size}")
            full = full.narrow(dim, tp_rank * (n // tp_size),
                               n // tp_size).contiguous()
            if self.mode == "col":
                features = tuple(full.shape[len(in_shape):])
            else:
                in_shape = (n // tp_size,) + in_shape[1:]
        self.in_shape, self.features = in_shape, features
        self.kernel = nn.Parameter(full)
        self.bias = (nn.Parameter(torch.zeros(self.features, device=device))
                     if use_bias else None)

    def forward(self, x):
        n = len(self.in_shape)
        lead = tuple(x.shape[:-n])
        xm = x.reshape(lead + (int(np.prod(self.in_shape)),)).to(self.dtype)
        km = self.kernel.reshape(xm.shape[-1], -1).to(self.dtype)
        y = torch.matmul(xm, km).reshape(lead + self.features)
        if self.mode == "row":
            # the Megatron g-op: one all-reduce completes the product
            y = reduce_from_tp(y, _tp_group(self.tp_axis, self.tp_size))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class VocabHead(nn.Module):
    """Output projection to vocab logits: model-dtype operands, f32
    accumulation, f32 logits (the reference's ``preferred_element_type``
    dot). The upcast operands are exact, so the f32 product equals a
    bf16-operand/f32-accumulate one. The bias stays f32, as in flax."""

    def __init__(self, d_model: int, vocab_size: int, dtype, device, gen):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(_trunc_normal(
            (d_model, vocab_size), d_model, device, gen))
        self.bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, x):
        x = x.to(self.dtype).to(torch.float32)
        kernel = self.kernel.to(self.dtype).to(torch.float32)
        return torch.matmul(x, kernel) + self.bias


class KVCache:
    """Decode-mode KV cache of a :class:`TransformerLM`, updated in place
    (the torch form of the reference's functional ``cache`` collection).

    ``layers[i]`` holds ``key``/``value`` (model dtype or int8) and, for
    int8, ``key_scale``/``value_scale`` (f32, initialized to ones like
    the reference).

    - Slot layout: each leaf is stored flat as ``[B * L + 1, ...]`` and
      attended through :meth:`view` as ``[B, L, ...]``; the extra last
      row absorbs dropped writes (chunk padding, positions past ``L``) —
      the reference's scatter ``mode='drop'`` without a host sync.
      ``index`` is the ``[B]`` per-row cursor (int64), advanced by the
      model after every call; a scalar-cursor model keeps all rows at
      one value.
    - Paged layout: each leaf is the pool ``[num_pages, block_size,
      ...]``; block 0 is the trash block; cursors are host-owned
      (``seq_lens`` per call), so ``index`` is None.
    """

    def __init__(self, layers: List[dict], index: Optional[torch.Tensor],
                 batch: int, length: int, paged: bool):
        self.layers = layers
        self.index = index
        self.batch = batch
        self.length = length
        self.paged = paged

    def view(self, layer: dict, name: str) -> torch.Tensor:
        """The ``[B, L, ...]`` view of a slot-layout leaf (contiguous)."""
        t = layer[name]
        return t[: self.batch * self.length].view(
            (self.batch, self.length) + tuple(t.shape[1:]))

    def leaves(self):
        for layer in self.layers:
            yield from layer.values()


class CausalSelfAttention(nn.Module):
    """Causal self-attention with the reference's projections (fused
    ``qkv`` for MHA, ``q_proj``/``kv_proj`` for GQA, ``out``). Decode
    configuration comes from the owning :class:`TransformerLM` at call
    time (``cfg``), so one set of parameters serves every twin."""

    def __init__(self, d_model: int, num_heads: int,
                 num_kv_heads: Optional[int], dtype, device, gen,
                 tp_size: int = 1, tp_axis: str = "tp", tp_rank: int = 0):
        super().__init__()
        H = num_heads
        hd = d_model // H
        Hk = num_kv_heads or H
        # this rank's heads: H/tp query heads over Hk/tp KV heads
        self.num_heads, self.num_kv_heads = H // tp_size, Hk // tp_size
        self.head_dim = hd
        self.dtype = dtype
        self.tp_size, self.tp_axis = tp_size, tp_axis
        tp = dict(tp_size=tp_size, tp_axis=tp_axis, tp_rank=tp_rank)
        if Hk == H:
            self.qkv = TPDenseGeneral((d_model,), (3, H, hd), dtype, device,
                                      gen, mode="col", shard_dim=1, **tp)
        else:
            self.q_proj = TPDenseGeneral((d_model,), (H, hd), dtype, device,
                                         gen, mode="col", shard_dim=0, **tp)
            self.kv_proj = TPDenseGeneral((d_model,), (2, Hk, hd), dtype,
                                          device, gen, mode="col",
                                          shard_dim=1, **tp)
        self.out = TPDenseGeneral((H, hd), (d_model,), dtype, device, gen,
                                  mode="row", **tp)

    # -- kernel selection -------------------------------------------------

    @staticmethod
    def _use_paged_kernel(cfg, hd, device) -> bool:
        """Resolve ``paged_kernel``: 'gather' keeps the reference,
        'pallas' forces the hand-written kernel (the plain version on CPU
        tensors), 'auto' defers to the kernel's preferred() gate."""
        if cfg.paged_kernel == "gather":
            return False
        if cfg.paged_kernel == "pallas":
            return True
        return _pa.preferred(hd, cfg.page_block_size, device=device)

    @staticmethod
    def _use_prefill_kernel(cfg, T, hd, L, device) -> bool:
        """Resolve ``prefill_kernel`` for a chunk: decode steps (T == 1)
        and 'gather' keep the dense reference, 'splash' forces the
        kernel, 'auto' defers to its preferred() gate."""
        if T < 2 or cfg.prefill_kernel == "gather":
            return False
        if cfg.prefill_kernel == "splash":
            return True
        return _sp.preferred(T, hd, L, device=device)

    # -- attends -----------------------------------------------------------

    def _cached_attend(self, cfg, q, k, v, cache, layer, cur, valid_lens):
        """Write this call's K/V at each row's cursor, then attend q over
        the whole slot cache. Padding tokens (``t >= valid_lens[b]``) and
        positions past the cache are dropped into the trash row."""
        B, T, _, hd = q.shape
        L = cache.length
        t = torch.arange(T, device=q.device)
        pos = cur[:, None] + t[None]  # [B, T] absolute
        if cfg.rope:
            q = apply_rope(q, pos)
            k = apply_rope(k, pos)
        ok = pos < L
        if valid_lens is not None:
            ok = ok & (t[None] < valid_lens[:, None])
        rows = torch.arange(B, device=q.device)[:, None] * L
        flat = torch.where(ok, rows + pos, B * L).reshape(-1)

        def put(name, new):
            leaf = layer[name]
            leaf[flat] = new.reshape((B * T,) + tuple(new.shape[2:])).to(
                leaf.dtype)

        _write_kv(put, k, v, cfg.cache_dtype == "int8")
        if cfg.cache_dtype == "int8":
            keys = _pa.dequantize_int8(cache.view(layer, "key"),
                                       cache.view(layer, "key_scale"),
                                       self.dtype)
            vals = _pa.dequantize_int8(cache.view(layer, "value"),
                                       cache.view(layer, "value_scale"),
                                       self.dtype)
        else:
            keys = cache.view(layer, "key")
            vals = cache.view(layer, "value")
        if self._use_prefill_kernel(cfg, T, hd, L, q.device):
            return _sp.splash_prefill_attention(
                q.contiguous(), keys, vals, cur.to(torch.int32))
        return _sp.splash_prefill_reference(q, keys, vals, cur)

    def _paged_attend(self, cfg, q, k, v, layer, block_tables, seq_lens,
                      valid_lens):
        """Paged twin of :meth:`_cached_attend`: token ``t`` of row ``b``
        lands in physical block ``block_tables[b, pos // bs]`` at offset
        ``pos % bs``; chunk padding goes to the trash block 0. The attend
        is the paged-attention kernel, or the gathered reference view
        (then the splash kernel for chunks where selected)."""
        T, hd = q.shape[1], q.shape[3]
        bs = cfg.page_block_size
        MB = block_tables.shape[-1]
        L = MB * bs
        quant = cfg.cache_dtype == "int8"
        t = torch.arange(T, device=q.device)
        pos = seq_lens.long()[:, None] + t[None]  # [B, T] absolute
        if cfg.rope:
            q = apply_rope(q, pos)
            k = apply_rope(k, pos)
        blk = torch.gather(block_tables.long(), 1,
                           torch.clamp(pos // bs, max=MB - 1))
        off = pos % bs
        if valid_lens is not None:
            blk = torch.where(t[None] < valid_lens[:, None], blk, 0)

        def put(name, new):
            leaf = layer[name]
            leaf[blk, off] = new.to(leaf.dtype)

        _write_kv(put, k, v, quant)
        ks = layer["key_scale"] if quant else None
        vs = layer["value_scale"] if quant else None
        tables = block_tables.to(torch.int32)
        if self._use_paged_kernel(cfg, hd, q.device):
            return _pa.paged_attention(
                q.contiguous(), layer["key"], layer["value"], tables,
                seq_lens.to(torch.int32), ks, vs)
        keys, vals = _pa.gathered_view(layer["key"], layer["value"], tables,
                                       ks, vs, self.dtype)
        if self._use_prefill_kernel(cfg, T, hd, L, q.device):
            return _sp.splash_prefill_attention(
                q.contiguous(), keys.contiguous(), vals.contiguous(),
                seq_lens.to(torch.int32))
        return _sp.splash_prefill_reference(q, keys, vals, seq_lens)

    def forward(self, x, cfg, cache=None, layer=None, cur=None,
                block_tables=None, seq_lens=None, valid_lens=None):
        B, T, D = x.shape
        H, Hk, hd = self.num_heads, self.num_kv_heads, self.head_dim
        # one conjugate for every column-parallel projection of x
        x = copy_to_tp(x, _tp_group(self.tp_axis, self.tp_size))
        if Hk == H:
            qkv = self.qkv(x)  # [B, T, 3, H, hd]
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self.q_proj(x)  # [B, T, H, hd]
            kv = self.kv_proj(x)  # [B, T, 2, Hk, hd]
            k, v = kv[:, :, 0], kv[:, :, 1]
        if cfg.decode:
            if cfg.paged:
                out = self._paged_attend(cfg, q, k, v, layer, block_tables,
                                         seq_lens, valid_lens)
            else:
                out = self._cached_attend(cfg, q, k, v, cache, layer, cur,
                                          valid_lens)
            return self.out(out)
        if cfg.attention == "ring":
            group, shard = _ring_shard(cfg)
        if cfg.rope:
            # global positions: ring shards offset by their shard index
            pos = torch.arange(T, device=x.device)
            if cfg.attention == "ring":
                pos = pos + shard * T
            q = apply_rope(q, pos)
            k = apply_rope(k, pos)
        if Hk != H:
            # training/prefill attends over full query heads: each KV head
            # repeated across its G query heads (jnp.repeat on axis 2)
            k = torch.repeat_interleave(k, H // Hk, dim=2)
            v = torch.repeat_interleave(v, H // Hk, dim=2)
        mode = cfg.attention
        if mode == "standard":
            if T <= TransformerLM._DENSE_MAX_T:
                mode = "dense"
            else:
                # the kernels skip the masked causal tiles the blocked op
                # computes; CPU tensors (and shapes the kernels do not
                # take) keep the blocked op, through the shared predicate
                mode = ("pallas" if _fa.preferred(T, hd, q.dtype, q.device)
                        else "blocked")
        if mode == "pallas":
            out = _fa.pallas_causal_attention(q, k, v)
        elif mode == "blocked":
            out = blocked_causal_attention(q, k, v)
        elif mode == "dense":
            out = self._dense_attend(q, k, v)
        elif mode == "ring":
            out = ring_attention(q, k, v, group=group, causal=True)
        else:
            raise ValueError(
                f"Unknown attention mode '{cfg.attention}'. "
                "Known: standard, dense, blocked, pallas, ring")
        return self.out(out)

    def _dense_attend(self, q, k, v):
        T, hd = q.shape[1], q.shape[3]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
        logits = logits * (1.0 / np.sqrt(hd))
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, _NEG_INF))
        probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(self.dtype), v)


class Block(nn.Module):
    """Pre-norm block: attention and the dense GELU(tanh) MLP, or with
    ``moe_experts > 0`` a Switch-MoE MLP (``moe``). ``forward`` returns
    ``(x, aux)``: the MoE layer's aux loss, None for a dense block."""

    def __init__(self, d_model: int, num_heads: int,
                 num_kv_heads: Optional[int], mlp_ratio: int, dtype, device,
                 gen, tp_size: int = 1, tp_axis: str = "tp",
                 tp_rank: int = 0, moe_experts: int = 0, ep_size: int = 1,
                 ep_axis: str = "ep", ep_rank: int = 0, moe_top_k: int = 1):
        super().__init__()
        tp = dict(tp_size=tp_size, tp_axis=tp_axis, tp_rank=tp_rank)
        self.tp_size, self.tp_axis = tp_size, tp_axis
        self.ep_size, self.ep_axis = ep_size, ep_axis
        self.LayerNorm_0 = LayerNorm(d_model, dtype, device)
        self.CausalSelfAttention_0 = CausalSelfAttention(
            d_model, num_heads, num_kv_heads, dtype, device, gen, **tp)
        self.LayerNorm_1 = LayerNorm(d_model, dtype, device)
        if moe_experts > 0:
            self.moe = SwitchMoE(d_model, moe_experts, d_model * mlp_ratio,
                                 dtype, device, gen, ep_size=ep_size,
                                 ep_rank=ep_rank, top_k=moe_top_k)
        else:
            self.mlp_up = TPDenseGeneral((d_model,), (d_model * mlp_ratio,),
                                         dtype, device, gen, mode="col",
                                         **tp)
            self.mlp_down = TPDenseGeneral((d_model * mlp_ratio,),
                                           (d_model,), dtype, device, gen,
                                           mode="row", **tp)

    def forward(self, x, cfg, cache=None, layer=None, cur=None,
                block_tables=None, seq_lens=None, valid_lens=None):
        h = self.LayerNorm_0(x)
        x = x + self.CausalSelfAttention_0(h, cfg, cache, layer, cur,
                                           block_tables, seq_lens,
                                           valid_lens)
        h = self.LayerNorm_1(x)
        if hasattr(self, "moe"):
            group = (_ep_mesh(self.ep_axis, self.ep_size).group(self.ep_axis)
                     if self.ep_size > 1 else None)
            h, aux = self.moe(h, group)
            return x + h, aux
        h = self.mlp_up(copy_to_tp(h, _tp_group(self.tp_axis,
                                                self.tp_size)))
        h = F.gelu(h, approximate="tanh")  # flax nn.gelu's default
        h = self.mlp_down(h)
        return x + h, None


# configuration fields of TransformerLM (constructor keywords besides
# device/seed); clone() copies them and shares the parameters
_CONFIG_FIELDS = (
    "vocab_size", "d_model", "num_heads", "num_layers", "max_len", "dtype",
    "attention", "tp_size", "moe_experts", "ep_size", "ep_axis",
    "moe_top_k", "remat", "decode", "pos_emb",
    "num_kv_heads", "cache_dtype", "slot_cursor", "paged",
    "page_block_size", "num_pages", "paged_kernel", "prefill_kernel",
    "features_only", "seq_axis", "tp_axis",
)


@register_model("transformer_lm")
class TransformerLM(nn.Module):
    """Decoder-only LM: tokens ``[B, T]`` -> logits ``[B, T, vocab]`` f32
    (or the ``ln_f`` features with ``features_only=True``).

    Constructor keywords mirror the reference module's attributes; add
    ``device`` (default: the CUDA card, raising without one — pass
    ``"cpu"`` explicitly for the host) and ``seed`` (the parameter
    init's ``torch.Generator`` seed). Decode twins come from
    :meth:`clone` and take a :class:`KVCache` from :meth:`init_cache`.
    A ``tp_size > 1`` model is built inside ``with mesh:`` (its rank is
    ``tp_rank``, this process's coordinate on the mesh's ``tp_axis``)
    and runs inside a bound mesh of the same tp size; :meth:`shard`
    makes one from a ``tp_size=1`` model's weights. An ``ep_size > 1``
    MoE model likewise (its rank ``ep_rank`` on ``ep_axis``).
    """

    _DENSE_MAX_T = 512

    def __init__(self, vocab_size: int = 1024, d_model: int = 256,
                 num_heads: int = 4, num_layers: int = 4,
                 max_len: int = 2048, dtype=torch.bfloat16,
                 attention: str = "standard", tp_size: int = 1,
                 moe_experts: int = 0, ep_size: int = 1,
                 ep_axis: str = "ep", moe_top_k: int = 1,
                 remat: str = "none",
                 decode: bool = False, pos_emb: str = "sinusoidal",
                 num_kv_heads: Optional[int] = None,
                 cache_dtype: str = "model", slot_cursor: bool = False,
                 paged: bool = False, page_block_size: int = 16,
                 num_pages: int = 0, paged_kernel: str = "auto",
                 prefill_kernel: str = "auto", features_only: bool = False,
                 seq_axis: str = "sp", tp_axis: str = "tp", device=None,
                 seed: int = 0):
        super().__init__()
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        cfg = dict(locals())
        for name in _CONFIG_FIELDS:
            setattr(self, name, cfg[name])
        self._validate()
        self.tp_rank = (_tp_mesh(tp_axis, tp_size).index(tp_axis)
                        if tp_size > 1 else 0)
        self.ep_rank = (_ep_mesh(ep_axis, ep_size).index(ep_axis)
                        if ep_size > 1 else 0)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tp = dict(tp_size=tp_size, tp_axis=tp_axis, tp_rank=self.tp_rank,
                  moe_experts=moe_experts, ep_size=ep_size, ep_axis=ep_axis,
                  ep_rank=self.ep_rank, moe_top_k=moe_top_k)
        self.embed = Embed(vocab_size, d_model, dtype, dev, gen)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, num_kv_heads, 4, dtype, dev, gen, **tp)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, dtype, dev)
        self.head = VocabHead(d_model, vocab_size, dtype, dev, gen)
        self._set_pos_table()

    def _validate(self):
        if self.remat not in ("none", "block"):
            raise ValueError(
                f"Unknown remat policy '{self.remat}'. Known: none, block")
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1; got {self.tp_size}")
        if self.moe_experts < 0 or self.ep_size < 1:
            raise ValueError(f"moe_experts={self.moe_experts} and ep_size="
                             f"{self.ep_size} must be >= 0 and >= 1")
        if self.moe_experts and self.moe_experts % self.ep_size:
            raise ValueError(f"num_experts={self.moe_experts} not divisible "
                             f"by ep_size={self.ep_size}")
        if self.ep_size > 1 and not self.moe_experts:
            raise ValueError(f"ep_size={self.ep_size} shards MoE experts: "
                             f"set moe_experts > 0")
        if self.moe_experts and self.tp_size > 1:
            raise ValueError(
                "moe_experts with tp_size > 1 is not supported: the MoE "
                "step shards (dp, ep) only, as the reference's does")
        if self.pos_emb not in ("sinusoidal", "rope"):
            raise ValueError(
                f"Unknown pos_emb '{self.pos_emb}'. Known: sinusoidal, rope")
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model={self.d_model} not divisible by "
                             f"num_heads={self.num_heads}")
        Hk = self.num_kv_heads or self.num_heads
        if self.num_heads % Hk:
            raise ValueError(f"num_heads={self.num_heads} not divisible by "
                             f"num_kv_heads={Hk}")
        if self.num_heads % self.tp_size:
            raise ValueError(f"num_heads={self.num_heads} not divisible by "
                             f"tp_size={self.tp_size}")
        if Hk % self.tp_size:
            raise ValueError(
                f"num_kv_heads={Hk} not divisible by tp_size="
                f"{self.tp_size} (each tp shard needs whole KV heads)")
        if self.cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"Unknown cache_dtype '{self.cache_dtype}'. "
                "Known: model, int8")
        if self.prefill_kernel not in ("auto", "splash", "gather"):
            raise ValueError(
                f"Unknown prefill_kernel '{self.prefill_kernel}'. "
                "Known: auto, splash, gather")
        if self.paged_kernel not in ("auto", "pallas", "gather"):
            raise ValueError(
                f"Unknown paged_kernel '{self.paged_kernel}'. "
                "Known: auto, pallas, gather")
        if self.slot_cursor and not self.decode:
            raise ValueError(
                "slot_cursor=True (per-row cache cursors) requires "
                "decode=True")
        if self.paged:
            if not self.decode:
                raise ValueError(
                    "paged=True (block-pooled KV cache) requires "
                    "decode=True")
            if self.slot_cursor:
                raise ValueError(
                    "paged and slot_cursor are mutually exclusive cache "
                    "layouts")
            if self.num_pages < 2:
                raise ValueError(
                    f"paged mode needs num_pages >= 2 (block 0 is the "
                    f"reserved trash block); got {self.num_pages}")
        if self.decode and self.attention == "ring":
            raise ValueError(
                "decode mode needs a single-host attention mode "
                "(sequence-parallel decoding is not supported)")

    def _set_pos_table(self):
        table = torch.from_numpy(
            sinusoidal_positions(self.max_len, self.d_model))
        self.register_buffer("pos_table", table.to(self.device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def config(self) -> dict:
        return {name: getattr(self, name) for name in _CONFIG_FIELDS}

    def clone(self, **overrides) -> "TransformerLM":
        """A twin with some configuration replaced (``decode=True``,
        ``paged=True``, ``max_len=...``) that SHARES this module's
        parameters — the torch form of flax's ``model.clone`` over one
        parameter tree."""
        unknown = set(overrides) - set(_CONFIG_FIELDS)
        if unknown:
            raise TypeError(f"clone() got unknown fields {sorted(unknown)}")
        twin = type(self).__new__(type(self))
        nn.Module.__init__(twin)
        cfg = self.config()
        cfg.update(overrides)
        for name in _CONFIG_FIELDS:
            setattr(twin, name, cfg[name])
        twin.tp_rank, twin.ep_rank = self.tp_rank, self.ep_rank
        for fixed in ("vocab_size", "d_model", "num_heads", "num_layers",
                      "num_kv_heads", "dtype", "tp_size", "tp_axis",
                      "moe_experts", "ep_size", "ep_axis", "moe_top_k"):
            if cfg[fixed] != getattr(self, fixed):
                raise ValueError(f"clone() cannot change '{fixed}': the "
                                 f"parameters are shared")
        twin._validate()
        twin.embed, twin.blocks = self.embed, self.blocks
        twin.ln_f, twin.head = self.ln_f, self.head
        twin._set_pos_table()
        return twin

    def shard(self, mesh, tp_axis: str = "tp") -> "TransformerLM":
        """A tensor-parallel twin of this ``tp_size=1`` model for this
        process's position on ``mesh``'s ``tp_axis``: the same
        configuration at ``tp_size = mesh.axis_size(tp_axis)``, holding
        contiguous copies of this rank's slices of the weights (its own
        parameters, not shared)."""
        from distkeras_torch.parallel.spmd import shard_state

        if self.tp_size != 1:
            raise ValueError("shard() takes a tp_size=1 model; this one "
                             f"has tp_size={self.tp_size}")
        n = mesh.axis_size(tp_axis)
        with mesh:
            twin = type(self)(**dict(self.config(), tp_size=n,
                                     tp_axis=tp_axis),
                              device=self.device)
        twin.load_state_dict(shard_state(self.state_dict(), twin.tp_rank,
                                         n))
        return twin

    def init_cache(self, batch: int = 1) -> KVCache:
        """Zeroed decode cache for this (decode-mode) twin: ``batch``
        slots of ``max_len`` positions, or the paged pool."""
        if not self.decode:
            raise ValueError("init_cache needs a decode twin "
                             "(model.clone(decode=True))")
        # this rank's KV heads under tensor parallelism
        Hk = (self.num_kv_heads or self.num_heads) // self.tp_size
        hd = self.d_model // self.num_heads
        quant = self.cache_dtype == "int8"
        store = torch.int8 if quant else self.dtype
        if self.paged:
            lead = (self.num_pages, self.page_block_size)
        else:
            lead = (batch * self.max_len + 1,)
        dev = self.device
        layers = []
        for _ in range(self.num_layers):
            layer = {
                "key": torch.zeros(lead + (Hk, hd), dtype=store, device=dev),
                "value": torch.zeros(lead + (Hk, hd), dtype=store,
                                     device=dev),
            }
            if quant:
                layer["key_scale"] = torch.ones(lead + (Hk,), device=dev)
                layer["value_scale"] = torch.ones(lead + (Hk,), device=dev)
            layers.append(layer)
        index = (None if self.paged
                 else torch.zeros(batch, dtype=torch.long, device=dev))
        return KVCache(layers, index, batch, self.max_len, self.paged)

    def forward(self, tokens, cache: Optional[KVCache] = None,
                block_tables=None, seq_lens=None, valid_lens=None,
                return_aux: bool = False):
        """Logits (or ``ln_f`` features) of ``tokens [B, T]``; with
        ``return_aux``, ``(out, auxes)``: the aux loss of each MoE layer,
        in layer order."""
        B, T = tokens.shape
        if (self.tp_size > 1 and _tp_mesh(self.tp_axis, self.tp_size).index(
                self.tp_axis) != self.tp_rank):
            raise ValueError(
                f"this tp model holds rank {self.tp_rank}'s slices but runs "
                f"at coordinate {current_mesh().index(self.tp_axis)} of the "
                f"bound mesh's '{self.tp_axis}' axis")
        if (self.ep_size > 1 and _ep_mesh(self.ep_axis, self.ep_size).index(
                self.ep_axis) != self.ep_rank):
            raise ValueError(
                f"this ep model holds rank {self.ep_rank}'s experts but runs "
                f"at coordinate {current_mesh().index(self.ep_axis)} of the "
                f"bound mesh's '{self.ep_axis}' axis")
        if valid_lens is not None and not (self.slot_cursor or self.paged):
            raise ValueError(
                "valid_lens (chunked mixed prefill/decode) needs per-row "
                "cursors: slot_cursor=True or paged=True")
        cur = None
        if self.decode:
            if cache is None or cache.paged != self.paged:
                raise ValueError(
                    "decode mode needs this twin's KVCache "
                    "(model.init_cache(batch))")
            if self.paged:
                if block_tables is None or seq_lens is None:
                    raise ValueError(
                        "paged mode needs block_tables [B, max_blocks] and "
                        "seq_lens [B] passed per call")
                cur = seq_lens.long()
            else:
                cur = cache.index
            if valid_lens is not None:
                valid_lens = valid_lens.long()
        x = self.embed(tokens)
        if self.pos_emb != "rope":
            pos = torch.arange(T, device=x.device)
            if self.attention == "ring":
                # each shard holds a T/sp slice: positions are global
                pos = pos + _ring_shard(self)[1] * T
            if self.decode:
                pos = pos[None, :] + cur[:, None]
            # clip like jnp.take(mode='clip'): chunk padding positions may
            # run past max_len, and their (garbage, finite) rows are
            # never read
            taken = self.pos_table[torch.clamp(pos, 0, self.max_len - 1)]
            x = x + taken.to(self.dtype)
        remat = (self.remat == "block" and not self.decode
                 and torch.is_grad_enabled())
        auxes = []
        for i, block in enumerate(self.blocks):
            if remat:
                x, aux = remat_block(block, x, self)
            else:
                layer = cache.layers[i] if cache is not None else None
                x, aux = block(x, self, cache, layer, cur, block_tables,
                               seq_lens, valid_lens)
            if aux is not None:
                auxes.append(aux)
        if self.decode and not self.paged:
            cache.index += T if valid_lens is None else valid_lens
        x = self.ln_f(x)
        out = x if self.features_only else self.head(x)
        return (out, auxes) if return_aux else out

    # read by CausalSelfAttention through ``cfg``
    @property
    def rope(self) -> bool:
        return self.pos_emb == "rope"


@register_model("moe_lm")
class MoeLM(TransformerLM):
    """TransformerLM with Switch-MoE MLPs (expert parallelism over
    ``ep``): the same decoder, each block's dense MLP a top-``moe_top_k``
    routed bank of ``moe_experts`` experts (default 8). Train with
    :func:`distkeras_torch.parallel.spmd.make_moe_lm_train_step` over a
    (dp, ep) mesh — the batch sharded over dp x ep jointly, the experts
    over ep."""

    def __init__(self, *args, moe_experts: int = 8, **kwargs):
        super().__init__(*args, moe_experts=moe_experts, **kwargs)


# -- decoding ---------------------------------------------------------------


def filter_logits(logits, temperature, top_k=None, top_p=None):
    """The sampling transform of :func:`sample_tokens` without the draw:
    ``[..., vocab]`` logits -> temperature-scaled, top-k/top-p-masked
    logits (``-inf`` outside the kept set). Requires ``temperature >
    0``. One descending sort serves both filters, as in the reference."""
    logits = logits / temperature
    if top_k is not None or top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        if top_k is not None:
            kth = sorted_desc[..., top_k - 1, None]
            logits = torch.where(logits < kth,
                                 torch.full_like(logits, -math.inf), logits)
            keep = torch.arange(sorted_desc.shape[-1],
                                device=logits.device) < top_k
            sorted_desc = torch.where(
                keep, sorted_desc, torch.full_like(sorted_desc, -math.inf))
        if top_p is not None:
            probs = torch.softmax(sorted_desc, dim=-1)
            beyond = torch.cumsum(probs, dim=-1) - probs > top_p
            kept = torch.where(beyond, torch.full_like(sorted_desc, math.inf),
                               sorted_desc)
            thresh = kept.amin(dim=-1, keepdim=True)
            logits = torch.where(logits < thresh,
                                 torch.full_like(logits, -math.inf), logits)
    return logits


def sample_tokens(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k=None, top_p=None):
    """One sampling step: ``[B, vocab]`` logits -> ``[B]`` int64 tokens.

    Greedy argmax at temperature 0 (no draw), else a Gumbel-max draw from
    ``softmax(filter_logits(...))`` with ``B * vocab`` uniforms from
    ``generator``. The serving engine samples each slot through this same
    function on a ``[1, vocab]`` slice with the slot's own generator, so
    its streams equal a solo B=1 :func:`generate` with the same seed."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    f = filter_logits(logits.to(torch.float32), temperature, top_k, top_p)
    u = torch.rand(f.shape, generator=generator, device=f.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(f - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def generate(model: TransformerLM, prompt, max_new_tokens: int,
             temperature: float = 0.0, seed: int = 0,
             eos_id: Optional[int] = None, top_k: Optional[int] = None,
             top_p: Optional[float] = None, return_steps: bool = False):
    """Autoregressive sampling from a :class:`TransformerLM` (the
    training-mode module; a decode twin sharing its parameters is cloned
    internally).

    One prefill pass writes the prompt's K/V into a ``max_len`` cache,
    then one-token decode steps attend over it. ``temperature`` 0 is
    greedy; otherwise each step draws from ``softmax(logits /
    temperature)`` filtered by ``top_k`` / ``top_p``, with a
    ``torch.Generator`` seeded from ``seed``. With ``eos_id`` finished
    rows keep emitting it and the loop stops once every row finished
    (the output is still eos-padded to ``max_new_tokens``).

    Returns ``[B, T_prompt + max_new_tokens]`` int64 on the model's
    device (and, with ``return_steps``, the decode steps run).
    """
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.to(device=model.device, dtype=torch.long)
    else:
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                 device=model.device)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be [B, T>=1]; got "
                         f"{tuple(prompt.shape)}")
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1; got {top_k}")
        top_k = min(top_k, model.vocab_size)
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
    B, Tp = prompt.shape
    if Tp + max_new_tokens > model.max_len:
        raise ValueError(
            f"prompt ({Tp}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_len={model.max_len} (the KV-cache length)"
        )
    dm = model.clone(decode=True)
    cache = dm.init_cache(B)
    last = dm(prompt, cache=cache)[:, -1]
    gen = torch.Generator(device=model.device).manual_seed(seed)
    fill = 0 if eos_id is None else eos_id
    toks = torch.full((B, max_new_tokens), fill, dtype=torch.long,
                      device=model.device)
    done = torch.zeros(B, dtype=torch.bool, device=model.device)
    steps = 0
    for i in range(max_new_tokens):
        if eos_id is not None and bool(done.all()):
            break
        tok = sample_tokens(last, gen, temperature, top_k, top_p)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        toks[:, i] = tok
        steps += 1
        if i + 1 < max_new_tokens:
            last = dm(tok[:, None], cache=cache)[:, -1]
    out = torch.cat([prompt, toks], dim=1)
    if return_steps:
        return out, steps
    return out


def _pick_rows(cache: KVCache, rows: torch.Tensor) -> KVCache:
    """A slot-layout cache holding rows ``rows`` of ``cache`` (repeats
    allowed): every leaf's ``[B, L, ...]`` view gathered, with a fresh
    trash row, and the rows' cursors."""
    B2, L = int(rows.numel()), cache.length
    layers = []
    for layer in cache.layers:
        new = {}
        for name, leaf in layer.items():
            flat = torch.empty((B2 * L + 1,) + tuple(leaf.shape[1:]),
                               dtype=leaf.dtype, device=leaf.device)
            flat[:B2 * L] = cache.view(layer, name).index_select(
                0, rows).reshape((B2 * L,) + tuple(leaf.shape[1:]))
            new[name] = flat
        layers.append(new)
    return KVCache(layers, cache.index.index_select(0, rows), B2, L, False)


@torch.no_grad()
def beam_search(model: TransformerLM, prompt, max_new_tokens: int,
                beam_size: int = 4, length_penalty: float = 0.0,
                eos_id: Optional[int] = None):
    """Beam-search decoding on the KV-cache decode path (the reference's
    ``beam_search``, distkeras_tpu transformer.py:1198).

    Fixed-width beam search: one prefill of the ``B`` prompt rows (the
    splash chunked-prefill kernel on a card), the cache tiled
    ``beam_size`` times along the batch, then each step scores all
    ``beam_size x vocab`` continuations per row, keeps the top
    ``beam_size`` by cumulative log-probability (ties to the lower flat
    index, as ``lax.top_k``) and gathers the caches of the surviving
    beams' parents.

    Args:
      length_penalty: GNMT-style alpha — candidates are ranked by
        ``logprob / ((5 + len) / 6) ** alpha`` with each hypothesis's
        own length (frozen when it finishes); 0 ranks by raw logprob.
      eos_id: finished beams freeze (their only continuation is ``eos``
        at zero cost), so shorter completed hypotheses compete with
        longer live ones.

    Returns ``[B, T_prompt + max_new_tokens]`` int64 on the model's
    device — each row's best beam.
    """
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.to(device=model.device, dtype=torch.long)
    else:
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                 device=model.device)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be [B, T>=1]; got "
                         f"{tuple(prompt.shape)}")
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1; got {beam_size}")
    B, Tp = prompt.shape
    if Tp + max_new_tokens > model.max_len:
        raise ValueError(
            f"prompt ({Tp}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_len={model.max_len} (the KV-cache length)"
        )
    K, V, dev = beam_size, model.vocab_size, model.device

    def penalize(scores, lengths):
        # GNMT: logprob / ((5 + hypothesis length) / 6) ** alpha
        if length_penalty == 0.0:
            return scores
        return scores / ((5.0 + lengths.to(torch.float32)) / 6.0
                         ) ** length_penalty

    dm = model.clone(decode=True)
    cache = dm.init_cache(B)
    logits = dm(prompt, cache=cache)
    # row b's beams live at rows b*K .. b*K+K-1
    cache = _pick_rows(cache, torch.arange(B, device=dev
                                           ).repeat_interleave(K))
    logp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
    logp = logp[:, None].expand(B, K, V)
    # beam 0 is live, the rest start at -inf so step 1 seeds K DISTINCT
    # tokens from the top of the prompt distribution
    scores = torch.full((B, K), -math.inf, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lens = torch.zeros((B, K), dtype=torch.long, device=dev)
    toks = torch.zeros((B, K, max_new_tokens), dtype=torch.long, device=dev)
    only_eos = None
    if eos_id is not None:
        only_eos = torch.full((V,), -math.inf, device=dev)
        only_eos[eos_id] = 0.0
    base = torch.arange(B, device=dev)[:, None] * K
    for i in range(max_new_tokens):
        if eos_id is not None:
            # finished beams: only eos continues, at zero cost
            logp = torch.where(done[..., None], only_eos, logp)
        cand_len = torch.where(done, lens, torch.full_like(lens, i + 1))
        flat = (scores[..., None] + logp).reshape(B, K * V)
        flat_len = cand_len[..., None].expand(B, K, V).reshape(B, K * V)
        # a stable descending sort: ties keep the lower flat index first
        idx = torch.sort(penalize(flat, flat_len), dim=1, descending=True,
                         stable=True).indices[:, :K]
        parent = idx // V
        token = idx % V
        scores = torch.gather(flat, 1, idx)
        lens = torch.gather(flat_len, 1, idx)
        toks = torch.gather(toks, 1, parent[..., None].expand(
            B, K, max_new_tokens)).clone()
        toks[:, :, i] = token
        if eos_id is not None:
            done = torch.gather(done, 1, parent) | (token == eos_id)
        if i + 1 == max_new_tokens:
            break  # the last step's logits would never be read
        cache = _pick_rows(cache, (base + parent).reshape(-1))
        logits = dm(token.reshape(B * K, 1), cache=cache)
        logp = torch.log_softmax(logits[:, -1].to(torch.float32),
                                 dim=-1).reshape(B, K, V)
    best = torch.argmax(penalize(scores, lens), dim=1)
    return torch.cat([prompt, toks[torch.arange(B, device=dev), best]],
                     dim=1)
