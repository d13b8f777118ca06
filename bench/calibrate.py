"""Readings that the check's limits are set from, in one process.

  python3 bench/calibrate.py --workload <cell> --seeds 11 12 ... \\
      --control-seeds 101 102 103 [--batches 40] [--seconds 30]

For each ``--seeds`` seed, the program's readings (what a run's check
computes): a train cell runs set-up, whose first steps the check
reads, a window of ``--seconds`` and the step after it; a prefill cell
runs ``--batches`` of the window's batches (a short window at the
cell's load, as many requests as a run compares).  For each
``--control-seeds`` seed, the readings of the control, the float32
reference computed in float8 (``bench/reference/common.py``) put in the
program's place, and, for a train cell, of a planted fault: the
reference on the first half of each step's rows, its mean over them
(a train cell's control and fault take the step after the window from
the program's state, as the check does, so they print the program's
readings too).  A state left unchanged reads 1 for ``change_gap`` by
the check's measure and needs no run.  One JSON line a reading; the
benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench.lib import core, spec  # noqa: E402


def _train_outputs(ctx, seconds: float) -> dict:
    drv = spec.driver_module("train")
    prog = drv.Program(ctx)
    prog.window(core.Run(cell=ctx.cell, kind="train"), seconds)
    out = prog.outputs()
    prog.close()
    return out


def program_readings(ctx, batches: int, warm: bool = True,
                     seconds: float = 30.0) -> dict:
    drv = spec.driver_module(ctx.traffic["driver"])
    if ctx.traffic["driver"] == "train":
        return drv.check(ctx, _train_outputs(ctx, seconds))
    prog = drv.Program(ctx, warm=warm)
    for _ in range(batches):
        prog._window_batch(None)
    out = prog.outputs()
    prog.close()
    del prog
    return drv.check(ctx, out)


def control_readings(ctx, batches: int, seconds: float = 30.0) -> dict:
    """{reading kind: readings} of the control (and the train cell's
    planted fault, and its program) on ``ctx``'s seed."""
    drv = spec.driver_module(ctx.traffic["driver"])
    if ctx.traffic["driver"] == "train":
        out = _train_outputs(ctx, seconds)
        late = out["late"]
        ref = drv.reference_record(ctx, late, "fp32")
        return {"program": drv.readings(out, ref),
                "control_fp8": drv.readings(
                    drv.reference_record(ctx, late, "fp8"), ref),
                "half_batch": drv.readings(
                    drv.reference_record(ctx, late, "fp32",
                                         rows=ctx.traffic["rows"] // 2),
                    ref)}
    plan = drv.Plan(ctx)
    smp = ctx.traffic["sample"]
    res = drv.Reservoir(ctx.seed, smp["state_slots"], 6)
    res_logits = drv.Reservoir(ctx.seed, smp["logit_slots"], 8)
    done = []
    for i in range(batches):
        length, rows = plan.batch(i)
        res.offer(i, length, rows)
        res_logits.offer(i, length, rows)
        done.append((i, length, rows, None))
    picks = {**{-1 - s: v for s, v in res.picks.items()},
             **res_logits.picks}
    chosen = drv.sample(ctx, done, {s: (i, r, None)
                                    for s, (i, r) in picks.items()})
    at = set(res.picks.values())
    low, low_states = drv.reference_outputs(ctx, chosen, at, "fp8")
    served = {k: int(v.argmax()) for k, v in low.items()}
    logits = {k: low[k] for k in res_logits.picks.values()}
    ref, ref_states = drv.reference_outputs(ctx, chosen, at, "fp32")
    return {"control_fp8": drv.readings(ctx, served, low_states, logits,
                                        ref, ref_states)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for j, seed in enumerate(args.seeds):
        t = time.perf_counter()
        r = program_readings(core.context(args.workload, seed, dev),
                             args.batches, warm=j == 0, seconds=args.seconds)
        print(json.dumps({"cell": args.workload, "kind": "program",
                          "seed": seed, "s": time.perf_counter() - t, **r}),
              flush=True)
    for seed in args.control_seeds:
        t = time.perf_counter()
        for kind, r in control_readings(
                core.context(args.workload, seed, dev), args.batches,
                args.seconds).items():
            print(json.dumps({"cell": args.workload, "kind": kind,
                              "seed": seed, "s": time.perf_counter() - t,
                              **r}), flush=True)
    print(json.dumps({"card": core.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
