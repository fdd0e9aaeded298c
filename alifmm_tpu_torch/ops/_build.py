"""Build helper of the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``alifmm_tpu_torch/_build/`` under a name keyed by a hash of the source and
the flags, and loaded with ``ctypes``.  ``-fmad=false`` keeps every multiply
and add apart, so that a kernel can follow its plain PyTorch twin operation
for operation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "CSRC", "compile_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the kernels are built from csrc/ "
                       "with the CUDA toolkit's nvcc")


def compile_library(source: str, stem: str, verbose: bool = False):
    """Compile ``source`` (a path under ``csrc/``) unless this version of it
    is built already, and load it.  Returns (library, compiler output);
    ``verbose`` adds ``-Xptxas -v``, whose report is that output."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    log = ""
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(so), log
