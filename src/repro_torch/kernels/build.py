"""Build the hand-written CUDA kernels with ``nvcc``, load them with ctypes,
and check what every wrapper hands them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/<name>-<hash>.so`` at the repository root, the hash taken
over the source and the flags, so a changed source rebuilds and an unchanged
one is loaded as it is. Nothing is built when a module is imported: the
first CUDA tensor that reaches a wrapper builds its kernel, and
:func:`build_all` builds every kernel at once, one ``nvcc`` per source, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("gather_pool", "cache_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {cuda_home}/bin or on PATH")
    return found


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def nvcc_command(name: str, out: pathlib.Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every kernel whose library is missing, in parallel. Returns
    ``{name: ptxas report}`` for what was compiled (registers, spills);
    raises with the compiler's output if any source fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        procs[name] = (out, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if missing), with
    ``argtypes`` set from ``signatures`` and an int return (the launch's
    ``cudaGetLastError()``) for every entry."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> torch.device:
    """All operands contiguous and on one CUDA device; that device."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices {devices}")
    device = devices.pop()
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {device}")
    return device
