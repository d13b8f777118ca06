"""The device trace of a traced segment: ``torch.profiler`` over a few
steps or batches, exported as a Chrome trace and reduced here.

The segment runs inside a ``record_function`` span named ``WINDOW``,
with the device synchronised at its start and its end; that span's
interval on the host is the traced window.  Device activity is every
event of the categories in ``DEVICE_CATS`` (kernels, copies, fills),
clipped to the window.  ``busy`` is the length of their union;
``idle_gaps`` names each stretch of the window with nothing on the
device by the innermost host event that covers its middle (an
annotation of the benchmark's, an aten operator or a CUDA runtime
call), summed by that name.
"""
from __future__ import annotations

import heapq
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

WINDOW = "bench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], units: int, top: int = 10) -> Dict:
    """Reduce Chrome-trace events (times in microseconds) to the
    traced window's numbers; ``units`` is the number of steps or
    batches the segment ran."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], defaultdict(float)
    n_ops = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        n_ops += 1
        dev.append((a, b))
        by_name[e.get("name", "?")] += (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", "?")) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW)
    # one sweep in time order: ``active`` holds the host events begun
    # by the gap's middle, shortest first; those ended are dropped as
    # they reach the top (a later middle never falls inside them)
    gaps = defaultdict(float)
    active: List[Tuple[float, float, str]] = []
    j = 0
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            s0, s1, name = host[j]
            heapq.heappush(active, (s1 - s0, s1, name))
            j += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "host: outside any traced call"
        gaps[name] += (b - a) * 1e-6
    rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_ops": n_ops, "units": units,
            "top_ops": [[k, v] for k, v in rank],
            "idle_gaps": [[k, v] for k, v in idle]}


def read_chrome_trace(path: Path) -> List[dict]:
    data = json.loads(Path(path).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data
