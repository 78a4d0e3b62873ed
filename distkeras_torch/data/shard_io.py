"""Sharded on-disk datasets — the port of
:mod:`distkeras_tpu.data.shard_io`, in the same on-disk format, so a
directory written by either package reads in the other bit for bit.

Format (one directory):

- ``meta.json`` — columns, dtypes, shapes, per-shard row counts;
- ``shard_{i:05d}.{column}.bin`` — raw C-order array bytes per column.

The loading path uses the repository's ``native/libdk_dataio.so`` through
ctypes (built by ``native/build.py`` when absent, like the transport
library of :mod:`distkeras_torch.networking`): positional file reads and
batch assembly run with the interpreter lock released, so the prefetch
thread of :meth:`ShardedDataset.batches` overlaps shard reads, the
shuffled row gather and (optionally) a fused float32 -> bfloat16 cast with
the device step. Everything falls back to numpy and torch without a
compiler.

bfloat16 host arrays are ``torch.bfloat16`` tensors (numpy has no such
dtype): the native kernel writes the bit patterns as ``uint16`` and the
tensor views them. The cast is round-to-nearest-even with NaNs quieted
(sign kept, payload truncated) — the bits the reference's cast gives.
``batches(pin_memory=True)`` assembles every column straight into pinned
host tensors, ready for ``.to(device, non_blocking=True)``.
"""

from __future__ import annotations

import ctypes
import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_torch.data.dataset import PartitionedDataset

# the repository's native/ (beside this package), built by native/build.py
_NATIVE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native", "libdk_dataio.so")
_native = None
_native_tried = False


def _load_native():
    global _native, _native_tried
    if _native is not None or _native_tried:
        return _native
    _native_tried = True
    if not os.path.exists(_NATIVE_PATH):
        try:
            import sys

            sys.path.insert(0, os.path.dirname(os.path.dirname(_NATIVE_PATH)))
            from native.build import build_lib

            build_lib("libdk_dataio.so", quiet=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_NATIVE_PATH)
    except OSError:
        return None
    vp, u64, i64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
    lib.dk_pread.restype = ctypes.c_int
    lib.dk_pread.argtypes = [ctypes.c_char_p, u64, u64, vp]
    lib.dk_gather_rows.restype = None
    lib.dk_gather_rows.argtypes = [vp, u64, vp, i64, vp]
    lib.dk_gather_cast_f32_bf16.restype = None
    lib.dk_gather_cast_f32_bf16.argtypes = [vp, u64, vp, i64, vp]
    lib.dk_cast_f32_bf16.restype = None
    lib.dk_cast_f32_bf16.argtypes = [vp, u64, vp]
    _native = lib
    return lib


def native_dataio_active() -> bool:
    return _load_native() is not None


def _empty(shape, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=pin)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _cast_fallback(x: np.ndarray) -> torch.Tensor:
    """float32 -> bfloat16 with torch's round-to-nearest-even; NaNs get
    the native kernel's bits (torch would give 0xFFFF)."""
    out = torch.from_numpy(x).to(torch.bfloat16)
    bits = x.view(np.uint32)
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    if nan.any():
        u16 = out.view(torch.int16).numpy().view(np.uint16)
        u16[nan] = ((bits[nan] >> 16) | 0x40).astype(np.uint16)
    return out


def cast_f32_bf16(x: np.ndarray, pin_memory: bool = False) -> torch.Tensor:
    """float32 array -> CPU ``torch.bfloat16`` tensor of its shape, through
    the native round-to-nearest-even kernel (the reference's bits, NaN and
    Inf included); torch's cast without the library."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load_native()
    if lib is None or x.size == 0:
        out = _cast_fallback(x)
        return out.pin_memory() if pin_memory else out
    out = _empty(x.shape, torch.bfloat16, pin_memory)
    lib.dk_cast_f32_bf16(x.ctypes.data_as(ctypes.c_void_p), x.size,
                         ctypes.c_void_p(out.data_ptr()))
    return out


# -- writing -----------------------------------------------------------------


def _check_cast(i: int, c: str, arr: np.ndarray, want_dtype: np.dtype):
    """The reference's same-kind cast rules for a partition whose column
    dtype differs from partition 0's: returns the cast array or raises."""
    if not np.can_cast(arr.dtype, want_dtype, casting="same_kind"):
        raise ValueError(
            f"partition {i} column '{c}': dtype {arr.dtype} is "
            f"incompatible with partition 0's {want_dtype}")
    cast = arr.astype(want_dtype)
    if arr.dtype.kind in "iu" and want_dtype.kind in "iu":
        # a range check: signed <-> unsigned wrap is bijective, so a
        # round trip would pass on wrapped data
        info = np.iinfo(want_dtype)
        if arr.size and not (info.min <= int(arr.min())
                             and int(arr.max()) <= info.max):
            raise ValueError(
                f"partition {i} column '{c}': values do not survive the "
                f"{arr.dtype}→{want_dtype} cast")
    elif want_dtype.kind in "iu" or arr.dtype.kind in "iu":
        if not np.array_equal(cast.astype(arr.dtype), arr):
            raise ValueError(
                f"partition {i} column '{c}': values do not survive the "
                f"{arr.dtype}→{want_dtype} cast")
    elif not np.all(np.isfinite(cast) == np.isfinite(arr)):
        raise ValueError(f"partition {i} column '{c}': {arr.dtype}→"
                         f"{want_dtype} overflows to inf")
    return cast


def write_shards(dataset: PartitionedDataset, directory: str,
                 rows_per_shard: Optional[int] = None) -> str:
    """Write a PartitionedDataset as a shard directory (one shard per
    partition by default, or re-split to ``rows_per_shard``)."""
    if rows_per_shard is not None:
        n = dataset.num_rows
        dataset = dataset.repartition(max(1, -(-n // rows_per_shard)))
    os.makedirs(directory, exist_ok=True)
    columns = dataset.columns
    meta: Dict = {"version": 1, "columns": {}, "shards": []}
    for c in columns:
        first = np.asarray(dataset.partition(0)[c])
        meta["columns"][c] = {"dtype": first.dtype.str,
                              "row_shape": list(first.shape[1:])}
    for i in range(dataset.num_partitions):
        part = dataset.partition(i)
        if sorted(part) != sorted(columns):
            raise ValueError(
                f"partition {i} columns {sorted(part)} != partition 0's "
                f"{sorted(columns)} — extra columns would be dropped and "
                "missing ones leave holes in the shard files")
        meta["shards"].append({"rows": len(next(iter(part.values())))})
        for c in columns:
            want_dtype = np.dtype(meta["columns"][c]["dtype"])
            want_shape = tuple(meta["columns"][c]["row_shape"])
            arr = np.ascontiguousarray(part[c])
            if arr.shape[1:] != want_shape:
                raise ValueError(
                    f"partition {i} column '{c}': row shape "
                    f"{arr.shape[1:]} != partition 0's {want_shape}")
            if arr.dtype != want_dtype:
                arr = _check_cast(i, c, arr, want_dtype)
            arr.tofile(os.path.join(directory, f"shard_{i:05d}.{c}.bin"))
    with open(os.path.join(directory, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return directory


# -- reading -----------------------------------------------------------------


class ShardedDataset:
    """Lazy reader over a shard directory.

    ``load()`` materializes everything into a PartitionedDataset (small
    data); ``batches()`` streams shuffled fixed-shape batches with a
    background prefetch thread (big data), reads and assembly in native
    code with the interpreter lock released."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, "meta.json")) as fh:
            self.meta = json.load(fh)
        self.columns = sorted(self.meta["columns"])
        self.shard_rows = [s["rows"] for s in self.meta["shards"]]

    @property
    def num_shards(self) -> int:
        return len(self.shard_rows)

    @property
    def num_rows(self) -> int:
        return sum(self.shard_rows)

    def _col_info(self, c) -> Tuple[np.dtype, Tuple[int, ...]]:
        info = self.meta["columns"][c]
        return np.dtype(info["dtype"]), tuple(info["row_shape"])

    def read_shard(self, i: int) -> Dict[str, np.ndarray]:
        """One shard as ``{column: array}``, by native pread when
        available."""
        out = {}
        lib = _load_native()
        for c in self.columns:
            dtype, row_shape = self._col_info(c)
            shape = (self.shard_rows[i],) + row_shape
            path = os.path.join(self.directory, f"shard_{i:05d}.{c}.bin")
            if lib is not None:
                buf = np.empty(shape, dtype)
                if lib.dk_pread(path.encode(), 0, buf.nbytes,
                                buf.ctypes.data_as(ctypes.c_void_p)) != 0:
                    raise IOError(f"dk_pread failed for {path}")
                out[c] = buf
            else:
                out[c] = np.fromfile(path, dtype=dtype).reshape(shape)
        return out

    def load(self) -> PartitionedDataset:
        """Materialize all shards (shard boundaries = partitions)."""
        return PartitionedDataset(
            [self.read_shard(i) for i in range(self.num_shards)])

    # -- streaming batches with native assembly --------------------------

    def _gather(self, arr: np.ndarray, idx: np.ndarray, cast_bf16: bool,
                pin: bool = False):
        """Shuffled batch assembly: native row gather (with the fused
        f32 -> bf16 cast). A cast column comes back as a bf16 tensor,
        every column as a (pinned) tensor when ``pin``, else numpy."""
        lib = _load_native()
        rows = len(idx)
        row_shape = arr.shape[1:]
        row_elems = int(np.prod(row_shape)) if row_shape else 1
        cast = cast_bf16 and arr.dtype == np.float32
        if lib is None or row_elems == 0:
            # numpy; also zero-width rows (nothing for C to copy)
            out = arr[idx]
            if cast:
                return cast_f32_bf16(out, pin_memory=pin)
            return torch.from_numpy(out).pin_memory() if pin else out
        idx = np.ascontiguousarray(idx, np.int64)
        src = arr.ctypes.data_as(ctypes.c_void_p)
        ip = idx.ctypes.data_as(ctypes.c_void_p)
        if cast:
            out = _empty((rows,) + row_shape, torch.bfloat16, pin)
            lib.dk_gather_cast_f32_bf16(src, row_elems, ip, rows,
                                        ctypes.c_void_p(out.data_ptr()))
            return out
        if pin:
            out = _empty((rows,) + row_shape, _torch_dtype(arr.dtype), True)
            dst = ctypes.c_void_p(out.data_ptr())
        else:
            out = np.empty((rows,) + row_shape, arr.dtype)
            dst = out.ctypes.data_as(ctypes.c_void_p)
        lib.dk_gather_rows(src, row_elems * arr.dtype.itemsize, ip, rows, dst)
        return out

    def batches(self, batch_size: int, shuffle_seed: Optional[int] = None,
                cast_bf16: Optional[List[str]] = None, prefetch: int = 2,
                drop_remainder: bool = True,
                shards: Optional[Sequence[int]] = None,
                pin_memory: bool = False) -> Iterator[Dict[str, object]]:
        """Stream fixed-shape batches shard by shard.

        Shuffle is two-level, as Spark users know it: the shard order is
        shuffled, then the rows within each shard (no global
        materialization), from ``shuffle_seed`` — the same rows in the
        same order as the reference's stream for the same seed.
        ``cast_bf16`` lists float32 columns cast during assembly (fused
        in C; they come out as ``torch.bfloat16`` tensors). A background
        thread prefetches ``prefetch`` batches ahead; reads and assembly
        run without the interpreter lock, overlapping the consumer's
        device work. ``pin_memory`` assembles into pinned tensors.

        ``shards`` restricts the stream to a subset of shard indices —
        how multi-process trainers give each process a disjoint slice of
        the directory (the shuffle then permutes within the subset)."""
        cast_cols = set(cast_bf16 or ())
        rng = (np.random.default_rng(shuffle_seed)
               if shuffle_seed is not None else None)
        shard_order = (np.asarray(list(shards), dtype=np.int64)
                       if shards is not None else np.arange(self.num_shards))
        if rng is not None:
            rng.shuffle(shard_order)

        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        end = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def put(item) -> bool:
            """A bounded put that gives up when the consumer is gone: the
            producer never blocks forever on an abandoned generator."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def assemble(shard, idx):
            return {c: self._gather(shard[c], idx, c in cast_cols,
                                    pin_memory) for c in self.columns}

        def producer():
            try:
                leftover: Optional[Dict[str, np.ndarray]] = None
                for si in shard_order:
                    if stop.is_set():
                        return
                    shard = self.read_shard(int(si))
                    if leftover is not None:
                        shard = {c: np.concatenate([leftover[c], shard[c]])
                                 for c in self.columns}
                        leftover = None
                    rows = len(next(iter(shard.values())))
                    idx = np.arange(rows)
                    if rng is not None:
                        rng.shuffle(idx)
                    n_full = rows // batch_size
                    for b in range(n_full):
                        if not put(assemble(
                                shard, idx[b * batch_size:(b + 1)
                                           * batch_size])):
                            return
                    tail = idx[n_full * batch_size:]
                    if len(tail):
                        leftover = {c: shard[c][tail] for c in self.columns}
                if leftover is not None and not drop_remainder:
                    # the remainder takes the same assembly path (casts
                    # applied, dtypes consistent)
                    n = len(next(iter(leftover.values())))
                    put(assemble(leftover, np.arange(n)))
            except BaseException as e:  # surfaced to the consumer
                error.append(e)
            finally:
                put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a full queue; its timed put
            # then sees stop and returns
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10)
        if error:
            raise error[0]


class ShardRowSource:
    """Random-access row view of a shard directory (the reference's grain
    ``RandomAccessDataSource`` adapter): rows resolve through a small LRU
    of shards, cold reads through the native loader."""

    def __init__(self, directory_or_dataset, cache_shards: int = 2):
        self._sd = (directory_or_dataset
                    if isinstance(directory_or_dataset, ShardedDataset)
                    else ShardedDataset(directory_or_dataset))
        self._starts = np.cumsum([0] + self._sd.shard_rows)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._cache_order: List[int] = []
        self._cache_shards = max(1, cache_shards)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._sd.num_rows

    def _shard_for(self, index: int) -> Tuple[int, int]:
        si = int(np.searchsorted(self._starts, index, side="right")) - 1
        return si, index - int(self._starts[si])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if index < 0:
            index += len(self)
        if not 0 <= index < len(self):
            raise IndexError(index)
        si, offset = self._shard_for(index)
        with self._lock:
            shard = self._cache.get(si)
        if shard is None:
            shard = self._sd.read_shard(si)
            with self._lock:
                self._cache[si] = shard
                self._cache_order.append(si)
                while len(self._cache_order) > self._cache_shards:
                    self._cache.pop(self._cache_order.pop(0), None)
        return {c: shard[c][offset] for c in self._sd.columns}


def map_shards(dataset: ShardedDataset, fn, out_directory: str) -> str:
    """Apply ``fn(shard_dict) -> shard_dict`` shard by shard, writing the
    results as a new shard directory — one shard resident at a time, so
    pipeline stages (transformers, predictors) run at disk scale as the
    reference's ``mapPartitions`` stages ran on Spark partitions."""
    os.makedirs(out_directory, exist_ok=True)
    meta: Dict = {"version": 1, "columns": None, "shards": []}
    for i in range(dataset.num_shards):
        out = fn(dataset.read_shard(i))
        rows = {len(v) for v in out.values()}
        if len(rows) != 1:
            raise ValueError(
                f"map_shards fn returned ragged columns for shard {i}: "
                f"{ {k: len(v) for k, v in out.items()} }")
        if meta["columns"] is None:
            meta["columns"] = {
                c: {"dtype": np.asarray(v).dtype.str,
                    "row_shape": list(np.asarray(v).shape[1:])}
                for c, v in out.items()}
        elif sorted(out) != sorted(meta["columns"]):
            raise ValueError(
                f"map_shards fn returned columns {sorted(out)} for shard "
                f"{i}, but shard 0 produced {sorted(meta['columns'])}")
        meta["shards"].append({"rows": rows.pop()})
        for c, v in out.items():
            arr = np.ascontiguousarray(v)
            want = meta["columns"][c]
            if arr.dtype.str != want["dtype"] or \
                    list(arr.shape[1:]) != want["row_shape"]:
                raise ValueError(
                    f"map_shards fn output for shard {i} column '{c}' is "
                    f"{arr.dtype.str}/{list(arr.shape[1:])}, but shard 0 "
                    f"produced {want['dtype']}/{want['row_shape']}")
            arr.tofile(os.path.join(out_directory, f"shard_{i:05d}.{c}.bin"))
    with open(os.path.join(out_directory, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return out_directory
