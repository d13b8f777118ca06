"""The program's spans in the device trace of a traced segment: which
device operations each span launched or caused.

The port opens ``repro_torch.utils.tracing.SPANS`` as
``record_function`` spans while a profiler runs; they sit in the same
Chrome trace as the kernels (``user_annotation`` events).  The rule:

  * a device operation of the traced window (``trace.WINDOW``) belongs
    to the program spans that cover its launch: the ``cuda_runtime`` or
    ``cuda_driver`` event with the same ``correlation``, else the CPU
    operator with the same ``External id``, on whichever thread
    launched it;
  * the kernels of the autograd's device thread (a thread that runs
    ``autograd::engine::evaluate_function`` events and opens no
    ``train.backward`` itself) also belong to the ``train.backward``
    that covers their launch in time;
  * where the innermost of the program spans and autograd nodes that
    cover a launch is an autograd node, the operation is also *caused
    by* the innermost program span that covered the node's forward
    operator: the profiler's ``fwdbwd`` flow (``s`` at the forward
    operator, ``f`` at the node) gives that link.  A program span
    inside the node (a ``model.layer`` recomputed by the activation
    checkpoint) wins over it, and remat's recomputed operators carry
    no flow.

Device time is the sum of the operations' durations clipped to the
window (these cells run one stream).  ``attribute`` reads it all in
one pass a thread, in time order.

The benchmark's metric readers take the numbers from the trace the
run wrote (``of``): run.py writes it to ``TRACE_FILE`` and keeps only
its summary (``Run.traced``), whose window and count of operations
tell a trace of this run from one of another; the first reader parses
it and keeps the result on the run.  Run as a script it prints every
number of a trace file:

  python3 bench/lib/spans.py build/bench/trace.json --units 1
"""
from __future__ import annotations

import bisect
import gc
import json
import os
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

if __package__ in (None, ""):
    _ROOT = str(Path(__file__).resolve().parents[2])
    sys.path[:0] = [_ROOT, os.path.join(_ROOT, "src")]

from bench.lib import trace as tr  # noqa: E402

try:
    from repro_torch.utils.tracing import SPANS
except ImportError:        # a program that opens no spans
    SPANS = ()

TRACE_FILE = Path(__file__).resolve().parents[2] / "build" / "bench" \
    / "trace.json"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NODE = "autograd::engine::evaluate_function"
HEAD_LOSS = {"model.head", "model.loss"}
PHASES = {"train.forward": "forward_s", "train.backward": "backward_s",
          "train.optimizer": "optimizer_s"}
# device seconds: all; under no span; each phase; recomputed and
# linked (of the backward); launched under or caused by each layer
SUMS = ("device_s", "unattributed_s", *PHASES.values(), "recompute_s",
        "linked_s", "attention_s", "head_loss_s", "cast_s")


def _span_stacks(intervals, points):
    """For each point ``(t, key)`` of one thread, the chain of
    ``intervals`` ``(start, end, item)`` that cover it, outermost
    first.  The intervals of a thread nest; one sweep in time order."""
    merged = sorted([(a, 0, -b, i) for i, (a, b, _) in enumerate(intervals)]
                    + [(t, 1, 0, k) for t, k in points])
    ends: List[float] = []
    items: list = []
    out = {}
    for t, kind, _, k in merged:
        # an interval ended by the time the next one starts, or before
        # a point
        while ends and (ends[-1] <= t if kind == 0 else ends[-1] < t):
            ends.pop()
            items.pop()
        if kind == 0:
            ends.append(intervals[k][1])
            items.append(intervals[k][2])
        else:
            out[k] = tuple(items)
    return out


def attribute(events: List[dict], units: int) -> Dict:
    """The traced window's device time by program span (seconds, the
    whole segment) and the counts the metrics divide by ``units``."""
    names = set(SPANS)
    win = None
    spans = defaultdict(list)       # tid -> [(start, end, name)]
    flow_s, flow_f = {}, {}         # flow id -> (tid, ts)
    nodes_at = {}                   # (tid, ts) -> end of the node there
    evaluate = defaultdict(list)    # tid -> [(start, end)] of NODE events
    launch_at = {}                  # correlation -> (tid, ts)
    device = []
    for e in events:
        cat = e.get("cat")
        if cat == "cpu_op":
            # autograd nodes: no aten:: operator is one
            name = e["name"]
            if name.startswith("aten::"):
                continue
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            if name.startswith(NODE):
                evaluate[e["tid"]].append((ts, end))
            # of operators begun at one instant, the outermost
            at = (e["tid"], ts)
            nodes_at[at] = max(end, nodes_at.get(at, end))
        elif cat in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch_at[c] = (e["tid"], float(e["ts"]))
        elif cat in tr.DEVICE_CATS:
            if e.get("ph") == "X":
                device.append(e)
        elif cat == "fwdbwd":
            (flow_s if e["ph"] == "s" else flow_f)[e["id"]] = (
                e["tid"], float(e["ts"]))
        elif cat == "user_annotation":
            if e.get("name") in names:
                ts = float(e["ts"])
                spans[e["tid"]].append((ts, ts + float(e.get("dur", 0.0)),
                                        e["name"]))
            elif e.get("name") == tr.WINDOW and win is None:
                win = e
    if win is None:
        raise ValueError(f"the trace holds no {tr.WINDOW!r} span")
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])

    backward = sorted((a, b) for tid in spans for a, b, n in spans[tid]
                      if n == "train.backward")
    device_threads = {t for t in evaluate
                      if not any(n == "train.backward"
                                 for _, _, n in spans.get(t, ()))}

    # each flow's autograd node, as the engine's evaluate_function event
    # around it (which also adds the node's outputs into the next
    # nodes' inputs), else the node alone
    nodes = defaultdict(list)       # tid -> [(start, end, ("node", id))]
    for t in evaluate:
        evaluate[t].sort()
    for fid, (tid, ts) in flow_f.items():
        if (tid, ts) not in nodes_at or fid not in flow_s:
            continue
        a, b = ts, nodes_at[(tid, ts)]
        ev = evaluate.get(tid, [])
        k = bisect.bisect_right(ev, (a, float("inf"))) - 1
        if k >= 0 and ev[k][1] >= b:
            a, b = ev[k]
        nodes[tid].append((a, b, ("node", fid)))
    points = defaultdict(list)
    for fid, (tid, ts) in flow_s.items():
        points[tid].append((ts, ("fwd", fid)))

    # each device operation's launch: its runtime call, else the CPU
    # operator of its External id
    kept, busy = [], []
    for e in device:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b > a:
            busy.append((a, b))
            args = e.get("args") or {}
            kept.append([b - a, launch_at.get(args.get("correlation")),
                         args.get("External id")])
    missing = {x[2] for x in kept if x[1] is None} - {None}
    if missing:
        by_ext = {}
        for e in events:
            if e.get("cat") == "cpu_op":
                ext = (e.get("args") or {}).get("External id")
                if ext in missing and ext not in by_ext:
                    by_ext[ext] = (e["tid"], float(e["ts"]))
        for x in kept:
            if x[1] is None:
                x[1] = by_ext.get(x[2])
    for j, (_, at, _) in enumerate(kept):
        if at is not None:
            points[at[0]].append((at[1], ("dev", j)))

    stacks = {}
    for tid, pts in points.items():
        iv = [(a, b, ("span", n)) for a, b, n in spans.get(tid, ())]
        stacks.update(_span_stacks(iv + nodes.get(tid, []), pts))

    def innermost_span(chain):
        for kind, v in reversed(chain):
            if kind == "span":
                return v
        return None

    caused_by = {fid: innermost_span(stacks.get(("fwd", fid), []))
                 for fid in flow_s}

    sums = dict.fromkeys(SUMS, 0.0)
    for j, (d, at, _) in enumerate(kept):
        chain = stacks.get(("dev", j), [])
        under = {v for kind, v in chain if kind == "span"}
        if (at is not None and at[0] in device_threads
                and "train.backward" not in under):
            k = bisect.bisect_right(backward, (at[1], float("inf")))
            if k and backward[k - 1][0] <= at[1] <= backward[k - 1][1]:
                under.add("train.backward")
        cause = (caused_by.get(chain[-1][1])
                 if chain and chain[-1][0] == "node" else None)
        sums["device_s"] += d
        if not under:
            sums["unattributed_s"] += d
        for n, key in PHASES.items():
            if n in under:
                sums[key] += d
        if {"train.backward", "model.layer"} <= under:
            sums["recompute_s"] += d
        elif "train.backward" in under and cause is not None:
            sums["linked_s"] += d
        both = under | {cause}
        if "layer.attention" in both:
            sums["attention_s"] += d
        if both & HEAD_LOSS:
            sums["head_loss_s"] += d
        if "model.cast" in both:
            sums["cast_s"] += d

    busy = tr._union(busy)
    starts = [a for a, _ in busy]
    idle, n_init, waits = 0.0, 0, []
    for tid in spans:
        for a, b, n in spans[tid]:
            if n == "data.wait" and w0 <= a <= w1:
                waits.append(b - a)
            if n != "serve.init_state":
                continue
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            n_init += 1
            covered = 0.0
            k = max(0, bisect.bisect_right(starts, a) - 1)
            while k < len(busy) and busy[k][0] < b:
                covered += max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
                k += 1
            idle += b - a - covered

    present = {n for tid in spans for a, b, n in spans[tid]
               if a < w1 and b > w0}
    return {"window_s": (w1 - w0) * 1e-6, "device_ops": len(kept),
            "units": units, "present": sorted(present),
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            **{k: v * 1e-6 for k, v in sums.items()},
            "init_state_idle_s": idle * 1e-6, "init_states": n_init,
            "data_wait_s": sum(waits) * 1e-6, "data_waits": len(waits)}


def read(path, units: int) -> Dict:
    """``attribute`` of the trace file ``path``.  The parsed trace is a
    million or so objects without cycles; the cyclic collector's passes
    over them would take longer than the attribution, so it waits."""
    was = gc.isenabled()
    gc.disable()
    try:
        return attribute(tr.read_chrome_trace(path), units)
    finally:
        if was:
            gc.enable()


def of(run) -> Optional[Dict]:
    """``attribute`` of the trace this run wrote, read once a run and
    kept as ``run.spans``; None for a program that opens no spans (not
    parsed), no traced segment, no trace file, or a file of another run
    (its window or count of operations differs from the run's
    summary)."""
    t = run.traced
    if not t or not SPANS:
        return None
    if "spans" not in vars(run):
        try:
            got = read(TRACE_FILE, t["units"])
        except OSError:
            got = None
        if got is not None and (got["window_s"], got["device_ops"]) != (
                t["window_s"], t["device_ops"]):
            got = None
        run.spans = got
    return run.spans


def per_unit_ms(run, kind: str, key: str, span: str) -> Optional[float]:
    """A metric of a run of ``kind`` (train | prefill): ``key`` of its
    trace in milliseconds a unit, or None where ``span`` was not opened
    in the window (a program without it)."""
    if run.kind != kind:
        return None
    got = of(run)
    if got is None or span not in got["present"]:
        return None
    return 1e3 * got[key] / got["units"]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Print a traced segment's "
                                 "device time by program span.")
    ap.add_argument("trace", nargs="?", default=str(TRACE_FILE))
    ap.add_argument("--units", type=int, default=1)
    args = ap.parse_args(argv)
    got = read(args.trace, args.units)
    busy, fwd = got["busy_s"], got["forward_s"]
    back = got["backward_s"] - got["recompute_s"]
    phases = sum(got[k] for k in PHASES.values())
    out = {k: got[k] for k in ("window_s", "busy_s", "device_ops", "units",
                               "present", "init_states", "data_waits")}
    out["ms_a_unit"] = {k[:-2]: 1e3 * got[k] / args.units
                        for k in SUMS + ("init_state_idle_s",)}
    out["shares"] = {
        "phases_of_busy": phases / busy if busy else None,
        "unattributed_of_busy": got["unattributed_s"] / busy if busy
        else None,
        "linked_of_backward_less_recompute": got["linked_s"] / back
        if back > 0 else None,
        "recompute_of_forward": got["recompute_s"] / fwd if fwd else None}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
