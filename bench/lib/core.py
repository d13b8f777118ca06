"""What every run shares: the record a run fills, the result line, the
device's description, the look for JAX in ``sys.modules``.

Imports torch only inside the functions that need the card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from typing import Any, Dict, List, Optional

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# NVIDIA's data sheet, H100 SXM, dense (no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver counted and the trace read.
    Metric readers (``bench/metrics``) take their numbers from here."""
    cell: str
    kind: str                      # the traffic's driver: train | prefill
    setup_s: float = 0.0
    window_s: float = 0.0          # host clock, synchronised at both ends
    units: int = 0                 # steps or batches in the window
    tokens: int = 0                # tokens of those units
    attempted: int = 0             # steps or requests
    failed: int = 0
    data_wait_s: float = 0.0       # host clock around the pipeline's next()
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    ttft_n: List[int] = dataclasses.field(default_factory=list)
    model_flops: float = 0.0       # the configuration's formula, window
    peak_flops: float = PEAK_BF16_FLOPS
    window_peak_bytes: int = 0     # max_memory_allocated over the window
    traced: Optional[Dict[str, Any]] = None   # lib.trace.summarize


def quantile_weighted(values: List[float], weights: List[int],
                      q: float) -> float:
    """The nearest-rank ``q`` quantile of ``values`` each repeated
    ``weights`` times (a batch's latency is that of each of its
    requests)."""
    pairs = sorted(zip(values, weights))
    total = sum(w for _, w in pairs)
    rank = max(1, math.ceil(q * total))
    seen = 0
    for v, w in pairs:
        seen += w
        if seen >= rank:
            return v
    raise ValueError("no values")


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def device_info(dev, count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them
    (a card set below 700 W runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def checks_block(readings: Dict[str, float], lim: Dict[str, float]) -> dict:
    """{number: {"value", "limit"}} in the limits file's order; a
    number is correct where it is finite and at most its limit."""
    return {k: {"value": readings.get(k, float("nan")), "limit": lim[k]}
            for k in lim}


def all_pass(block: dict) -> bool:
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in block.values())


def emit(result: dict, checks: dict) -> None:
    """Print the checks last on standard error, then the result line
    (checks last in it) last on standard output.  A number that is not
    finite is written as null in the line."""
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"])
                          else None, "limit": v["limit"]}
                      for k, v in checks.items()}
    print(json.dumps(line), flush=True)


@dataclasses.dataclass
class Ctx:
    """What a driver is handed: the cell, the seed, the device, and the
    files the manifest names for it (``smoke``: the CPU tests' sizes)."""
    cell: str
    seed: int
    device: Any
    smoke: bool
    config: Any            # bench/configs/<config>.py
    sizes: dict            # its sizes, as the reference reads them
    reference: Any         # bench/reference/<config>.py
    traffic: dict          # bench/traffic/<traffic>.json


def context(name: str, seed: int, device, smoke: bool = False) -> Ctx:
    """The ``Ctx`` of cell ``name`` (``smoke``: the mix's ``smoke``
    parameters over its own)."""
    from bench.lib import spec
    cell = spec.cell(name)
    traffic = spec.traffic(cell["traffic"])
    if smoke:
        traffic = {**traffic, **traffic["smoke"]}
    config = spec.config_module(cell["config"])
    return Ctx(cell=name, seed=seed, device=device, smoke=smoke,
               config=config, sizes=config.sizes(smoke),
               reference=spec.reference_module(cell["config"]),
               traffic=traffic)
