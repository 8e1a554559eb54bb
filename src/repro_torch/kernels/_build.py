"""Build and load the hand-written CUDA kernels (``kernels/csrc``).

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so

The build happens at first use (or up front through :func:`build_all`,
which starts one nvcc per source, all at once), into
``build/repro_torch_kernels/`` at the root of the checkout.  The file name
carries a hash of every source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("pdist", "lloyd", "score", "wkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple, object] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(name: str, extra_flags: tuple) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra_flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str, extra_flags: tuple = ()) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name, extra_flags)}.so"


def _start(name: str, extra_flags: tuple):
    """Launch nvcc for one source; returns (Popen | None, target path)."""
    out = library_path(name, extra_flags)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(name: str, started, out: Path) -> str:
    if started is None:
        return ""
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    tmp.replace(out)      # atomic publish: a reader never sees half a file
    return log


def build_all(extra_flags: tuple = ()) -> dict[str, str]:
    """Compile every kernel source in parallel (one nvcc each); returns
    nvcc's output per source (e.g. ``-Xptxas -v`` reports)."""
    with _lock:
        started = {n: _start(n, tuple(extra_flags)) for n in SOURCES}
        return {n: _finish(n, *started[n]) for n in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started, out = _start(name, ())
            _finish(name, started, out)
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
    return lib


def bind(name: str, symbol: str, n_ptr: int, n_int: int, *,
         stream: bool = True):
    """C entry ``symbol`` of library ``name`` with its argtypes set:
    ``n_ptr`` pointers, ``n_int`` ints, then (``stream``) the stream as a
    pointer.  Every pointer is a ``c_void_p``: a bare Python int would be
    passed as a 32-bit int and cut."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + ([ctypes.c_void_p] if stream else []))
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(x: torch.Tensor) -> int:
    """x's device's current stream as a raw handle: what
    ``torch.cuda.current_stream(x.device).cuda_stream`` gives, without
    building a Stream object (~4-5 us a call on the H100 machine's host,
    PERF.md).  ``_cuda_getCurrentRawStream`` is a private torch entry that
    torch's own generated code calls."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


class CudaKernel:
    """A launchable kernel entry with its launch counter.

    ``launches`` is a plain int, bumped once per kernel launch and nowhere
    else, so a run can show its main path went through the kernel; set it
    to 0 to start a count.  ``flops(*args, **kwargs)`` is the work of one
    call from its arguments.  While ``observers`` holds callables, a call
    that launched hands each of them (kernel, args, kwargs, result): how a
    counter of dispatched ops (``launch/hlo.py``) sees work that reaches
    the card through ``ctypes``, not through an aten op.
    """

    observers: list = []

    def __init__(self, name: str, fn, flops):
        self.name = name
        self._fn = fn
        self.flops = flops
        self.launches = 0

    def __call__(self, *args, **kwargs):
        if not CudaKernel.observers:
            return self._fn(self, *args, **kwargs)
        before = self.launches
        out = self._fn(self, *args, **kwargs)
        if self.launches != before:
            for obs in list(CudaKernel.observers):
                obs(self, args, kwargs, out)
        return out
