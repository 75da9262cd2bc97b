"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``tpu_plume_torch/_build/lib<name>-<hash>.so``.  ``ppo.cu`` and ``lstm.cu``
have a plain C interface and are loaded with ``ctypes`` (``load``);
``plume.cu`` and ``gather.cu`` are Python extension modules of
METH_FASTCALL functions, imported by ``load_module``, because their calls
are launch-bound and a ctypes call's argument conversion is most of their
host cost.  The hash
covers the source, every header of ``csrc/`` (``*.cuh``, which the sources
include) and the flags (the Python headers' directory among them), so an
edited source or header is rebuilt and an unchanged one is reused.
Nothing here runs at import time: the CPU tests import every module, and
there is no ``nvcc`` where they run.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict = {}   # by name: a ctypes.CDLL, or an extension module


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def nvcc_flags() -> tuple:
    """``NVCC_FLAGS`` and the running Python's headers, which a source with
    Python entry points (``plume.cu``, ``gather.cu``) includes."""
    return NVCC_FLAGS + ("-I", sysconfig.get_paths()["include"])


def library_path(name: str) -> str:
    digest = hashlib.sha1(" ".join(nvcc_flags()).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as fh:
            digest.update(os.path.basename(path).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *nvcc_flags()]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, source_path(name)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu ({proc.returncode}):\n{proc.stderr}")
        if verbose and proc.stderr:
            print(proc.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib


def load_module(name: str):
    """``csrc/<name>.cu`` imported as a Python extension module (its
    ``PyInit_<name>``), built on first use."""
    with _lock:
        mod = _loaded.get(name)
        if mod is None:
            spec = importlib.util.spec_from_file_location(
                f"tpu_plume_torch._build.{name}", build(name))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _loaded[name] = mod
        return mod
