"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C launch function.  It
is compiled with nvcc for sm_90a at first use, once per source content,
into ``vvctpu_torch/_build/`` and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD = PKG / "_build"


def load(name: str, verbose: bool = False):
    """Compile ``csrc/<name>.cu`` (unless a build of this exact source is
    present) and load it.  Returns (ctypes library, nvcc's output when it
    compiled now, with the ``-Xptxas -v`` register report if
    ``verbose``)."""
    src_path = PKG / "csrc" / f"{name}.cu"
    src = src_path.read_bytes()
    tag = hashlib.sha1(src + bytes([verbose])).hexdigest()[:12]
    out = BUILD / f"lib{name}-{tag}.so"
    log = ""
    if not out.exists():
        BUILD.mkdir(exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(src_path)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
        log = res.stdout + res.stderr
    return ctypes.CDLL(str(out)), log
