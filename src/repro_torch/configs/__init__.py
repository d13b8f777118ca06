"""Architecture registry of the port: ``get_config(arch_id)`` /
``list_archs()``.

One module per LM architecture of the JAX package's registry (the same
``CONFIG`` and ``smoke_config()``, field for field) plus ``emapprox``,
the paper's own PV-DBOW workload.  ``CONFIG`` is the full-size model;
``smoke_config()`` is the reduced, CPU-runnable one.

``list_archs()`` and ``ALIASES`` stay the JAX package's; the port's own
architectures (``PORT_ARCHS``, named by ``PORT_ALIASES``), which the
JAX package lacks, resolve through ``get_config`` as well.
"""
from __future__ import annotations

import importlib
from typing import List

_ARCHS = [
    "smollm_360m",
    "qwen2_5_14b",
    "starcoder2_3b",
    "internlm2_20b",
    "mamba2_780m",
    "whisper_small",
    "hymba_1_5b",
    "llama4_scout_17b_a16e",
    "llama4_maverick_400b_a17b",
    "llama_3_2_vision_11b",
]

ALIASES = {a.replace("_", "-"): a for a in _ARCHS}
ALIASES.update({
    "smollm-360m": "smollm_360m",
    "qwen2.5-14b": "qwen2_5_14b",
    "starcoder2-3b": "starcoder2_3b",
    "internlm2-20b": "internlm2_20b",
    "mamba2-780m": "mamba2_780m",
    "whisper-small": "whisper_small",
    "hymba-1.5b": "hymba_1_5b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
})

PORT_ARCHS = ["granite_4_0_h_micro"]
PORT_ALIASES = {"granite-4.0-h-micro": "granite_4_0_h_micro"}


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_config(arch: str, smoke: bool = False):
    name = ALIASES.get(arch) or PORT_ALIASES.get(arch, arch)
    mod_name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.CONFIG
