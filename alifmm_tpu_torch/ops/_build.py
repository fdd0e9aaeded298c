"""Build helper of the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``alifmm_tpu_torch/_build/`` under a name keyed by a hash of the source,
every local header it includes (``#include "..."``, followed through the
headers) and the flags, and loaded with ``ctypes``.  ``-fmad=false`` keeps every multiply
and add apart, so that a kernel can follow its plain PyTorch twin operation
for operation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "CSRC", "compile_library",
           "source_files", "source_digest"]

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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_files(source: str) -> list:
    """``source`` and every local header it includes, directly or through
    another header (resolved beside the including file), each once, in
    the order first met."""
    files, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as fh:
            todo += [os.path.join(os.path.dirname(path), inc.decode())
                     for inc in _LOCAL_INCLUDE.findall(fh.read())]
    return files


def source_digest(source: str) -> str:
    """Hash of ``source``, the headers it includes and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(source):
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + fh.read())
    return digest.hexdigest()


def compile_library(source: str, stem: str, verbose: bool = False):
    """Compile ``source`` (a path under ``csrc/``) unless this version of it
    and of its headers is built already, and load it.  Returns (library,
    compiler output); ``verbose`` adds ``-Xptxas -v``, whose report is that
    output."""
    digest = source_digest(source)
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest[:16]}.so")
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
