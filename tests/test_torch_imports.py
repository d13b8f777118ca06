"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package ``repro``,
importing it builds nothing, and its entry points run on CUDA unless
the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.kernels import common
assert not common._libs, "a kernel library was loaded at import"
print(len(names))
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_source_scan_finds_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)


def test_default_device_is_cuda_and_raises_without_gpu():
    from repro_torch.core.index import ApproxIndex
    from repro_torch.kernels.common import resolve_device
    z = np.zeros((2, 4), np.float32)
    sig = np.zeros((2, 1), np.uint32)
    kw = dict(word_vecs=z, shard_vecs=z, doc_vecs=None,
              planes=np.zeros((32, 4), np.float32), word_sig=sig,
              shard_sig=sig, doc_sig=None, bits=32,
              doc_freq=np.zeros(2, np.int64), n_docs=2, avg_doc_len=1.0)
    assert ApproxIndex(**kw, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert ApproxIndex(**kw).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ApproxIndex(**kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_library_build_needs_nvcc_only_at_first_launch(monkeypatch):
    from repro_torch.kernels import common
    assert common.CSRC.joinpath("asym.cu").exists()
    assert common.BUILD_DIR == ROOT / "build" / "kernels"
    if torch.cuda.is_available():
        return
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(common, "_libs", {})
    monkeypatch.setattr(common, "BUILD_DIR", ROOT / "build" / "nonexistent")
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        return
    with pytest.raises(RuntimeError, match="nvcc"):
        common.load_library("asym")
