"""Build and load the hand-written CUDA kernels.

The sources under ``kernels/csrc/`` have a plain C interface. They are
compiled with ``nvcc`` for ``sm_90a`` (Hopper), one ``nvcc -c`` per
source, all started together, and linked into one shared library that
is loaded with ``ctypes``. Nothing includes PyTorch's headers, so a
build takes seconds.

The build runs at first use, never at import, into
``<repo>/build/kernels/<hash>/`` (``.gitignore`` lists ``build/``),
where ``<hash>`` covers the sources and the flags: an edited source
builds a new library, and an unchanged one is loaded from the cache.
There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("edge_scan.cu", "round_step.cu", "queue_ingest.cu", "weight_update.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points and their argument types (every pointer and the
#: stream as c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "edge_scan_launch": [_P] * 7 + [_I] * 5 + [_P],
    "round_step_launch": [_P] * 8 + [_I, _F] + [_P] * 8 + [_I, _I, _P],
    "queue_ingest_launch": [_P] * 12 + [_I] * 4 + [_P],
    "weight_update_launch": [_P] * 8 + [_I] * 4 + [_P],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libtmsn_kernels.so"


def build() -> tuple[Path, float]:
    """Compile the sources if the cached library is missing; returns
    ``(path, seconds spent compiling)`` (0.0 on a cache hit)."""
    lib = library_path()
    if lib.is_file():
        return lib, 0.0
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
            objs.append(str(obj))
        failed = []
        for name, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(staged), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, lib)  # atomic: concurrent builders never see half a file
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and bind its entry points."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
