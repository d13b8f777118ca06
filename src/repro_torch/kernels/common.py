"""Shared helpers for the kernel wrappers: device selection,
plain/kernel dispatch and the CUDA kernel-library loader.  (The JAX
package's ``pad_rows`` has no counterpart: the CUDA kernels mask their
ragged edges themselves, so nothing is padded.)

Dispatch goes by where the tensors lie.  A CPU tensor takes the
kernel's plain PyTorch version (the counterpart of Pallas interpret
mode); a CUDA tensor takes the hand-written kernel, or the call raises.
There is no fallback from one to the other.

Kernel libraries are built from ``csrc/<name>.cu`` with ``nvcc`` into
``build/kernels/`` at the root of the checkout, on first use, and loaded
with ``ctypes`` (plain C entry points: pointers, ints and the stream as
``c_void_p``/``c_int``).  A library's file name carries the hash of its
source and flags, so an edited source is rebuilt and a stale library
is never loaded.  Importing this module builds and loads nothing: the
build happens at the first launch on a CUDA tensor, or when a caller
asks for it (``build_all``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """The device an entry point computes on: CUDA unless the caller
    names another.  Asking for CUDA on a machine without a GPU raises —
    nothing carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (kernel route),
    False when every tensor lies on the CPU (plain route).  Mixed or
    other devices raise."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {types}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str) -> None:
    """Run ``nvcc`` for ``csrc/<name>.cu`` unless its library for the
    current source hash exists; a failed build raises."""
    target = _lib_path(name)
    if target.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    done = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {done.returncode}):\n{done.stdout}")
    os.replace(tmp, target)


def build_all() -> None:
    """Build every ``csrc/*.cu`` whose library is missing, one ``nvcc``
    per source, all running together."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock, ThreadPoolExecutor(max(len(names), 1)) as pool:
        list(pool.map(_build, names))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed.
    A failed build or load raises."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build(name)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device`` as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
