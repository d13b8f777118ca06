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
print(" ".join(names))
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 24
    assert {"repro_torch.kernels.megascan", "repro_torch.kernels.megascan.ops",
            "repro_torch.kernels.megascan.kernel",
            "repro_torch.kernels.megascan.ref",
            "repro_torch.kernels.asym.ops",
            "repro_torch.kernels.hamming", "repro_torch.kernels.hamming.ops",
            "repro_torch.kernels.hamming.kernel",
            "repro_torch.kernels.hamming.ref",
            "repro_torch.runtime.executor",
            "repro_torch.kernels.negsamp", "repro_torch.kernels.negsamp.ops",
            "repro_torch.kernels.negsamp.kernel",
            "repro_torch.kernels.negsamp.ref",
            "repro_torch.kernels.kmeans", "repro_torch.kernels.kmeans.ops",
            "repro_torch.kernels.kmeans.kernel",
            "repro_torch.kernels.kmeans.ref",
            "repro_torch.core.pv_dbow", "repro_torch.core.allocation",
            "repro_torch.configs.emapprox",
            "repro_torch.models", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.blocks", "repro_torch.models.model",
            "repro_torch.launch.steps", "repro_torch.launch.serve",
            "repro_torch.utils.trees", "repro_torch.configs.smollm_360m",
            "repro_torch.configs.mamba2_780m",
            "repro_torch.configs.llama4_maverick_400b_a17b",
            "repro_torch.optimizer", "repro_torch.optimizer.adamw",
            "repro_torch.optimizer.quantized",
            "repro_torch.optimizer.schedules",
            "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
            "repro_torch.data.pipeline", "repro_torch.data.tokenizer",
            "repro_torch.launch.train", "repro_torch.distributed",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.mesh", "repro_torch.launch.specs",
            "repro_torch.launch.dryrun"} <= names


@pytest.mark.parametrize("pkg", ["core", "data", "utils", "distributed"])
def test_packages_re_export_the_reference_names(pkg):
    """Each of the reference's ``core``, ``data``, ``utils`` and
    ``distributed`` packages re-exports names from its modules; the
    port's package of the same name exports every one of them (read
    from the reference's source, nothing of it imported)."""
    import importlib
    src = ROOT / "src" / "repro" / pkg / "__init__.py"
    want = {a.asname or a.name for node in ast.walk(ast.parse(src.read_text()))
            if isinstance(node, ast.ImportFrom) for a in node.names}
    assert len(want) >= 5
    mod = importlib.import_module(f"repro_torch.{pkg}")
    assert not [n for n in sorted(want) if not hasattr(mod, n)]


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
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import (init_decode_state, init_params,
                                          init_stacked_params)
    cfg = get_config("smollm_360m", smoke=True)
    params = init_params(cfg, device="cpu")
    assert params["tok_emb"].device == torch.device("cpu")
    assert init_stacked_params(cfg, device="cpu")["tok_emb"].device.type == "cpu"
    train_argv = ["--smoke", "--steps", "1", "--batch", "1", "--seq", "8",
                  "--n-docs", "20"]
    if torch.cuda.is_available():
        assert ApproxIndex(**kw).device.type == "cuda"
        assert init_params(cfg)["tok_emb"].device.type == "cuda"
        assert init_stacked_params(cfg)["tok_emb"].device.type == "cuda"
        run = train_main(train_argv)
        assert run.params["tok_emb"].device.type == "cuda"
        assert init_decode_state(cfg, 1, 8).pos.device.type == "cuda"
        assert serve(cfg, 1, 4, 2).tokens.shape == (1, 2)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ApproxIndex(**kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg, 1, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_stacked_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(train_argv)
    assert train_main(train_argv + ["--device", "cpu"]).params[
        "tok_emb"].device.type == "cpu"
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


def test_library_name_covers_every_shared_header(tmp_path, monkeypatch):
    """An edit to a shared header alone names a new library, so a stale
    build is never loaded; an edit to another source does not."""
    from repro_torch.kernels import common
    for src in common.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert sorted(p.name for p in tmp_path.glob("*.cuh"))
    monkeypatch.setattr(common, "CSRC", tmp_path)
    before = {n: common._lib_path(n) for n in ("asym", "megascan")}
    header = tmp_path / "asym_tile.cuh"
    header.write_bytes(header.read_bytes() + b"// edited\n")
    after = {n: common._lib_path(n) for n in ("asym", "megascan")}
    assert all(before[n] != after[n] for n in before)
    megascan_before = after["megascan"]
    cu = tmp_path / "asym.cu"
    cu.write_bytes(cu.read_bytes() + b"// edited\n")
    assert common._lib_path("asym") != after["asym"]
    assert common._lib_path("megascan") == megascan_before
