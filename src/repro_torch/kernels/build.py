"""Build the port's CUDA kernels from the repository's sources at first
use and bind them with ``ctypes``.

Each ``kernels/<name>/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``).
The library name carries a hash of the source and the flags, so an
edited source is rebuilt and never mistaken for a stale build.
``build_all`` starts one ``nvcc`` per source at once, so the build takes
as long as the slowest source.  Nothing here runs at import time: a
machine without ``nvcc`` imports this module cleanly and fails only when
a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Iterable, List, Tuple

import torch

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
SOURCES = ("dense_3xtf32", "kv_restore", "moe_experts", "paged_attention",
           "rans_decode", "ssd_scan", "token_delta")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_n_sm: Dict[int, int] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _source(name: str) -> pathlib.Path:
    return KERNELS_DIR / name / f"{name}.cu"


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(_source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source not yet built, all at once; returns each
    library's ``ptxas`` report (registers, shared memory, spills) or ''
    for a library that was already built.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[Tuple[str, pathlib.Path, subprocess.Popen]] = []
    reports: Dict[str, str] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            reports[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The compiled library of kernel ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if kernel ``name``'s launcher returned a CUDA error code."""
    if err != 0:
        describe = getattr(load(name), f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name}: CUDA error {err} ({describe(err).decode()})")


def refuse_grad(op: str, *tensors) -> None:
    """Raise if grad mode is on and a tensor bound for kernel ``op``
    requires grad: the kernel has no backward, and its output would be
    cut off from autograd without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the CUDA kernel has no gradient; call it under "
            f"torch.no_grad() or on tensors that do not require grad")


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA ``device``, read once."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _n_sm[idx]
