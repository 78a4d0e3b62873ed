"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). The libraries land in
``build/distkeras_torch/`` at the repository root — a directory
``.gitignore`` lists — with nvcc's report beside each library, under
names that carry a hash of their sources,
so an edited source is rebuilt and an unchanged one is reused. All
sources compile in parallel, one ``nvcc`` process each.

Nothing here runs at import time: :func:`load` builds on first use, and
raises when ``nvcc`` is missing or a compile fails — there is no
fallback to the plain PyTorch versions.

Run ``python -m distkeras_torch.kernels.build`` to build eagerly and
print the compiler's register/shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "distkeras_torch"
SOURCES = ("paged_attention.cu", "splash_prefill.cu", "causal_attention.cu",
           "pair_attention.cu")
HEADERS = ("attn_common.cuh", "flash_bwd_sm90.cuh", "flash_fwd_sm90.cuh",
           "flash_mma.cuh", "serve_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ll = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p, strides as
# 64-bit integers
_SIGNATURES = {
    "dk_paged_attention": [_vp] * 8 + [_i] * 9 + [_f, _vp, _vp] + [_i] * 3,
    "dk_splash_prefill": [_vp] * 5 + [_i] * 7 + [_f, _vp, _vp] + [_i] * 3,
    "dk_causal_attention_fwd": [_vp] * 5 + [_i] * 4 + [_ll, _ll, _f, _vp],
    "dk_causal_attention_dq": [_vp] * 9 + [_i] * 4 + [_ll, _ll, _f, _vp],
    "dk_causal_attention_dkv": [_vp] * 10 + [_i] * 5 + [_ll, _ll, _f, _vp],
    "dk_pair_attention_fwd": [_vp] * 5 + [_i] * 6 + [_ll] * 4 + [_vp],
    "dk_pair_attention_dq": [_vp] * 9 + [_i] * 6 + [_ll] * 4 + [_vp],
    "dk_pair_attention_dkv": [_vp] * 10 + [_i] * 7 + [_ll] * 4 + [_vp],
}


class Kernels:
    """The loaded kernel entry points plus what the build took: ``seconds``
    (0.0 when every library was already built) and ``log`` (nvcc's
    output per source, including the ``-Xptxas -v`` report)."""

    def __init__(self, libs: Dict[str, ctypes.CDLL], seconds: float,
                 log: Dict[str, str]):
        self.libs = libs
        self.seconds = seconds
        self.log = log
        for name, argtypes in _SIGNATURES.items():
            fn = next(getattr(lib, name) for lib in libs.values()
                      if hasattr(lib, name))
            fn.argtypes = argtypes
            fn.restype = _i
            setattr(self, name, fn)
        err = libs[SOURCES[0]].dk_error_string
        err.argtypes, err.restype = [_i], ctypes.c_char_p
        self._err = err

    def error_string(self, code: int) -> str:
        return self._err(code).decode()


_lock = threading.Lock()
_loaded: Optional[Kernels] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from csrc/ at first use and need the CUDA "
        "toolkit")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for name in (source,) + HEADERS + tuple(NVCC_FLAGS):
        path = CSRC / name
        h.update(path.read_bytes() if path.exists() else name.encode())
    return h.hexdigest()[:12]


def _target(source: str) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}-{_digest(source)}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all at once (one
    nvcc process per source); returns nvcc's output per compiled source.
    Raises ``RuntimeError`` with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in SOURCES if not _target(s).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    for src in todo:
        tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[src] = out
        # the compiler's report (ptxas registers, spills, shared memory)
        # stays next to the library it describes
        _target(src).with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(src)
        else:
            os.replace(tmp, _target(src))
    if failed:
        detail = "\n".join(f"--- {s} ---\n{logs[s]}" for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


def load() -> Kernels:
    """Build (once per process, if needed) and load the kernels."""
    global _loaded
    with _lock:
        if _loaded is None:
            t0 = time.perf_counter()
            log = build_all()
            seconds = time.perf_counter() - t0 if log else 0.0
            libs = {s: ctypes.CDLL(str(_target(s))) for s in SOURCES}
            _loaded = Kernels(libs, seconds, log)
        return _loaded


def error_string(code: int) -> str:
    return load().error_string(code)


if __name__ == "__main__":
    k = load()
    for src, text in k.log.items():
        print(f"--- {src} ---\n{text}")
    print(f"built in {k.seconds:.1f} s into {BUILD_DIR}")
