"""Model and tree serialization — the port of
:mod:`distkeras_tpu.utils.serde`.

The reference ships a model as ``{'model': {name, kwargs}, 'weights':
msgpack_bytes}``: the module by registry name and constructor keywords,
the parameters as flax's msgpack encoding of a tree of numpy arrays.
This module reads and writes the same blob with plain ``msgpack`` (no
flax): an array is msgpack ext type 1 holding ``packb((shape, dtype
name, C-order bytes))``, a numpy scalar ext type 3, a complex ext type
2, and an array over 1 GiB a ``__msgpack_chunked_array__`` dict of
flat chunks — flax's own codec, so a blob written by either package
loads in the other. The wire (:mod:`distkeras_torch.networking`) sends
its messages through :func:`packb` / :func:`unpackb` here.

Trees are nested dicts (lists and tuples too) whose leaves are numpy
arrays, numpy scalars, Python scalars or tensors; a tensor is fetched to
the host as numpy before it is packed. Parameters are f32 masters, so
nothing bf16 goes on the wire; a bf16 array is packed and unpacked
through ``ml_dtypes`` when that package is there, and raises otherwise.

The port's models take a few keywords the reference's modules do not
(``in_features`` of the MLP, ``input_shape`` of the CNNs): they travel
beside ``kwargs`` under ``torch_kwargs``, which the reference ignores,
and a blob without them (the reference's) gets them from its weights.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# flax's limit per packed leaf (msgpack's own is 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"

# keywords of the port's models that the reference's modules do not take
_PORT_ONLY = ("in_features", "input_shape")
# keywords of the reference's modules that the port's do not take, with
# the only value the port can honor (anything else raises on load)
_REFERENCE_ONLY = {"tp_axis": "tp", "ep_size": 1, "ep_axis": "ep",
                   "moe_top_k": 1}


def _msgpack():
    import msgpack

    return msgpack


def _to_numpy(x):
    """A tensor or array-like leaf -> numpy (a tensor through the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.float().cpu().numpy().astype(_bf16_dtype())
        return x.cpu().numpy()
    return x


def _bf16_dtype():
    try:
        import ml_dtypes
    except ImportError:
        raise TypeError("a bfloat16 array needs ml_dtypes to be packed or "
                        "unpacked; the port's parameters are f32 masters"
                        ) from None
    return np.dtype(ml_dtypes.bfloat16)


def _dtype_from_name(name: bytes):
    if name == b"bfloat16":
        return _bf16_dtype()
    return np.dtype(name.decode())


def _array_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    return _msgpack().packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                            use_bin_type=True)


def _array_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = _msgpack().unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=_dtype_from_name(name)).reshape(
        shape, order="C")


def _ext_pack(x):
    msgpack = _msgpack()
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _array_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    raise TypeError(f"can not serialize {type(x).__name__!r} object")


def _ext_unpack(code, data):
    msgpack = _msgpack()
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _host(tree):
    """Tensors -> numpy, tuples -> lists, oversized arrays -> chunks: what
    flax's ``msgpack_serialize`` packs after its own conversions."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    leaf = _to_numpy(tree)
    if (isinstance(leaf, np.ndarray)
            and leaf.size * leaf.dtype.itemsize > MAX_CHUNK_SIZE):
        return _chunk(leaf)
    return leaf


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def packb(obj: Any) -> bytes:
    """A tree -> msgpack bytes in flax's encoding (``msgpack_serialize``)."""
    return _msgpack().packb(_host(obj), default=_ext_pack, strict_types=True)


def unpackb(data: bytes) -> Any:
    """Inverse of :func:`packb` (``msgpack_restore``): nested dicts and
    lists with read-only numpy leaves."""
    return _unchunk(_msgpack().unpackb(data, ext_hook=_ext_unpack,
                                       raw=False))


def serialize_pytree(tree: Any) -> bytes:
    """Tree of arrays or tensors -> msgpack bytes (tensors are fetched to
    the host)."""
    return packb(tree)


def _restore_like(like, state):
    if isinstance(like, dict):
        missing = set(map(str, like)) - set(state)
        if missing:
            raise ValueError(f"the serialized tree lacks keys "
                             f"{sorted(missing)} of the template")
        return {k: _restore_like(v, state[str(k)]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = (state if isinstance(state, list)
                 else [state[str(i)] for i in range(len(state))])
        return type(like)(_restore_like(a, b) for a, b in zip(like, items))
    if isinstance(like, torch.Tensor):  # same dtype and device
        return torch.tensor(np.array(state)).to(like.device, like.dtype)
    return state


def deserialize_pytree(data: bytes, like: Optional[Any] = None) -> Any:
    """msgpack bytes -> tree. Without ``like``: nested dicts of numpy
    arrays (enough for a parameter tree). With it: the structure of
    ``like`` (its lists and tuples; tensor leaves come back as tensors of
    the template's dtype and device)."""
    state = unpackb(data)
    return state if like is None else _restore_like(like, state)


def _encode_kwarg(v):
    """A constructor keyword made msgpack-safe: dtypes (torch or numpy)
    become ``{"__dtype__": name}``; containers recurse."""
    if isinstance(v, torch.dtype):
        return {"__dtype__": str(v).split(".")[-1]}
    if isinstance(v, (type, np.dtype)):
        try:
            return {"__dtype__": np.dtype(v).name}
        except TypeError:
            pass
    if isinstance(v, (list, tuple)):
        return [_encode_kwarg(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode_kwarg(x) for k, x in v.items()}
    return v


def _decode_kwarg(v):
    """Inverse of :func:`_encode_kwarg`, to torch dtypes; lists become
    tuples (every sequence keyword of the model zoo is a tuple)."""
    if isinstance(v, dict):
        if set(v) == {"__dtype__"}:
            return getattr(torch, v["__dtype__"])
        return {k: _decode_kwarg(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_decode_kwarg(x) for x in v)
    return v


def serialize_model(module_spec: dict, params: Any) -> dict:
    """``(module spec, params)`` -> ``{'model': {name, kwargs,
    torch_kwargs}, 'weights': bytes}``. ``module_spec`` is
    :func:`distkeras_torch.models.model_spec`'s ``{name, kwargs}``;
    ``params`` the flax-layout tree (``bridge.params_to_jax``)."""
    kwargs = dict(module_spec.get("kwargs", {}))
    port = {k: kwargs.pop(k) for k in _PORT_ONLY if k in kwargs}
    spec = {"name": module_spec["name"],
            "kwargs": {k: _encode_kwarg(v) for k, v in kwargs.items()}}
    if port:
        spec["torch_kwargs"] = {k: _encode_kwarg(v) for k, v in port.items()}
    return {"model": spec, "weights": serialize_pytree(params)}


def _inferred_kwargs(name: str, params: dict) -> dict:
    """The port-only keywords of a blob that lacks them (the
    reference's): the MLP's input width from its first kernel, a CNN's
    input channels from its first convolution at the class's default
    height and width."""
    tree = params.get("params", params)
    if name == "mlp":
        return {"in_features": int(np.shape(tree["Dense_0"]["kernel"])[0])}
    if name in ("mnist_cnn", "cifar_cnn") and "Conv_0" in tree:
        hw = (28, 28) if name == "mnist_cnn" else (32, 32)
        return {"input_shape":
                hw + (int(np.shape(tree["Conv_0"]["kernel"])[2]),)}
    return {}


def deserialize_model(blob: dict, device=None):
    """Inverse of :func:`serialize_model` -> ``(module, params)``: the
    port's module built from the spec on ``device`` (default: the card)
    with the weights loaded, and the flax-layout tree."""
    import inspect

    from distkeras_torch import bridge
    from distkeras_torch.models.registry import _REGISTRY, get_model

    spec = blob["model"]
    name = spec["name"]
    params = deserialize_pytree(blob["weights"])
    kwargs = {k: _decode_kwarg(v) for k, v in spec.get("kwargs", {}).items()}
    port = {k: _decode_kwarg(v)
            for k, v in (spec.get("torch_kwargs") or {}).items()}
    if not port:
        port = _inferred_kwargs(name, params)
    kwargs.update(port)
    cls = _REGISTRY.get(name)
    if cls is not None:
        accepted = inspect.signature(cls.__init__).parameters
        for k in [k for k in kwargs if k not in accepted]:
            if k not in _REFERENCE_ONLY or kwargs[k] != _REFERENCE_ONLY[k]:
                raise ValueError(
                    f"model '{name}': keyword {k}={kwargs[k]!r} has no "
                    f"counterpart in the port")
            del kwargs[k]
    module = get_model(name, device=device, **kwargs)
    bridge.params_from_jax(params, module)
    return module, params
