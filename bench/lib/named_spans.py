"""Device time under each named span of a traced segment, by the span
that covers an operation's launch.

``bench/lib/spans.py`` sums a fixed set of keys; this file answers for
any span name, by the launch half of its rule with no autograd (the
prefill records none): a device operation of the traced window
(``trace.WINDOW``), clipped to the window, belongs to every
``user_annotation`` span that covers its launch on the launching
thread, the launch being the ``cuda_runtime`` or ``cuda_driver`` event
with the operation's ``correlation``, else the CPU operator with its
``External id``.  A span inside a span of the same name counts once.

The trace is the one run.py wrote (``spans.TRACE_FILE``), parsed once a
run: the first reader keeps the sums of every name on the run
(``run.named_spans``), or None for no traced segment, no file, or a
file of another run (its window or count of device operations differs
from the run's summary).
"""
from __future__ import annotations

import gc
from collections import defaultdict
from typing import Dict, List, Optional

from bench.lib import spans
from bench.lib import trace as tr


def attribute(events: List[dict]) -> Dict:
    """{"window_s", "device_ops", "sums": {span name: device seconds}}
    of the traced window; a name present in the window maps to its sum,
    0.0 where it launched nothing."""
    win = None
    intervals = defaultdict(list)     # tid -> [(start, end, name)]
    launch_at, by_ext = {}, {}
    device = []
    for e in events:
        cat = e.get("cat")
        if cat == "user_annotation":
            ts = float(e["ts"])
            if e.get("name") == tr.WINDOW:
                if win is None:
                    win = (ts, ts + float(e["dur"]))
            else:
                intervals[e["tid"]].append(
                    (ts, ts + float(e.get("dur", 0.0)), e.get("name")))
        elif cat in spans.LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch_at[c] = (e["tid"], float(e["ts"]))
        elif cat == "cpu_op":
            ext = (e.get("args") or {}).get("External id")
            if ext is not None and ext not in by_ext:
                by_ext[ext] = (e["tid"], float(e["ts"]))
        elif cat in tr.DEVICE_CATS and e.get("ph") == "X":
            device.append(e)
    if win is None:
        raise ValueError(f"the trace holds no {tr.WINDOW!r} span")
    w0, w1 = win
    sums: Dict[str, float] = {}
    for tid, iv in intervals.items():
        for a, b, name in iv:
            if a < w1 and b > w0:
                sums.setdefault(name, 0.0)
    points = defaultdict(list)        # tid -> [(launch ts, seconds)]
    n_ops = 0
    for e in device:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        n_ops += 1
        args = e.get("args") or {}
        at = launch_at.get(args.get("correlation")) \
            or by_ext.get(args.get("External id"))
        if at is not None:
            points[at[0]].append((at[1], (b - a) * 1e-6))
    for tid, pts in points.items():
        # one sweep in time order; the spans of a thread nest
        merged = sorted([(a, 0, -b, name) for a, b, name in intervals[tid]]
                        + [(t, 1, 0, d) for t, d in pts],
                        key=lambda x: x[:3])
        ends: List[float] = []
        names: List[str] = []
        for t, kind, negb, item in merged:
            while ends and (ends[-1] <= t if kind == 0 else ends[-1] < t):
                ends.pop()
                names.pop()
            if kind == 0:
                ends.append(-negb)
                names.append(item)
            else:
                for name in set(names):
                    sums[name] = sums.get(name, 0.0) + item
    return {"window_s": (w1 - w0) * 1e-6, "device_ops": n_ops,
            "sums": sums}


def of(run) -> Optional[Dict]:
    """``attribute`` of the trace this run wrote, parsed once a run and
    kept as ``run.named_spans`` (None: see the module docstring)."""
    t = run.traced
    if not t:
        return None
    if "named_spans" not in vars(run):
        was = gc.isenabled()
        gc.disable()
        try:
            got = attribute(tr.read_chrome_trace(spans.TRACE_FILE))
        except (OSError, ValueError):
            got = None
        finally:
            if was:
                gc.enable()
        if got is not None and (got["window_s"], got["device_ops"]) != (
                t["window_s"], t["device_ops"]):
            got = None
        run.named_spans = got
    return run.named_spans


def per_unit_ms(run, kind: str, name: str) -> Optional[float]:
    """Device time under span ``name``, in milliseconds a traced unit,
    of a run of ``kind`` (train | prefill); None where the span was not
    opened in the window (a program or a model without it)."""
    if run.kind != kind or not run.traced or run.traced["units"] <= 0:
        return None
    got = of(run)
    if got is None or name not in got["sums"]:
        return None
    return 1e3 * got["sums"][name] / run.traced["units"]
