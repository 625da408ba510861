"""Build the port's CUDA kernels at first use, from the sources in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.
PyTorch's headers stay out, so a build takes seconds, not minutes. The
library lands in ``build/repro_torch/`` at the root of the checkout,
named by a hash of its source, the local headers and the flags: an
edited source or header rebuilds, an unchanged one is reused. ``nvcc``
and ``ctypes`` are touched only inside the functions here, so the CPU
tests import the kernel modules freely.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --fmad=false: no a*b+c contraction, so the kernel rounds each product and
# sum as the plain PyTorch version does, op by op (a kernel that wants a
# fused multiply-add, as attention's dot products do, calls fmaf itself)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, object] = {}
_FUNCTIONS: Dict[str, object] = {}


def nvcc_path() -> str:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build only where the toolkit is")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by a hash of
    the source, the local headers (``csrc/*.cuh``) and the flags: an
    edited header rebuilds every kernel."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns the seconds each build took
    (0.0 for a library already built). The compiler's report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    nvcc = None
    running = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report from the build of ``name`` ('' if cached by
    an earlier process that kept no log)."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def load(name: str):
    """The ``ctypes.CDLL`` of kernel ``name``, built first if needed."""
    if name not in _LOADED:
        import ctypes

        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def function(name: str, *, pointers: int, ints: int, floats: int,
             entry: str | None = None):
    """The C entry point ``<entry>_launch`` (``entry`` defaults to
    ``name``) of kernel ``name``, typed for ``ctypes``: ``pointers``
    device pointers, ``ints`` C ints, ``floats`` C floats, then the stream;
    it returns the launch's CUDA error code. Typed once per process."""
    entry = entry or name
    if entry not in _FUNCTIONS:
        import ctypes

        fn = getattr(load(name), f"{entry}_launch")
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_float] * floats + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FUNCTIONS[entry] = fn
    return _FUNCTIONS[entry]
