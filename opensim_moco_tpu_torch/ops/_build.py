"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use.

Each source becomes a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go to
``opensim_moco_tpu_torch/_build/`` (git-ignored), named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. :func:`build_all` starts one ``nvcc`` per source at
once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("btb",)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)"
                           ": the CUDA kernels are built at first use")
    return str(path)


def _target(name):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return src, BUILD / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES):
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns the
    compiler's resource report (``-Xptxas -v``) per source built."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    reports = {}
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
        os.replace(tmp, so)
        reports[name] = out
    return reports


def load(name):
    """The ``ctypes`` handle of library ``name``, built if needed."""
    if name not in _loaded:
        _, so = _target(name)
        if not so.exists():
            build_all((name,))
        _loaded[name] = ctypes.CDLL(str(so))
    return _loaded[name]
