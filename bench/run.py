"""Run one benchmark cell once and print its result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  The cell
is an entry of ``BENCHMARK.json``'s ``workloads``; its configuration,
traffic, reference, metrics and limits are the files that
``bench/lib/spec.py`` finds by name.  Set-up (imports, the CUDA
context, weights, data, warm-up) runs from the start of the process;
then the traffic's driver runs the window for ``--seconds``; with
``--trace 1`` a few more steps or batches run under ``torch.profiler``;
then the program's state is freed and the float32 reference checks
what the timed path produced.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, then ``checks`` (each
number compared, beside its limit; they are also the last lines of
standard error).  Without a GPU, or with the JAX package loaded once
the window has closed, it prints no result and exits with another code
than 0.  Build and kernel caches stay under ``build/`` in the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(ROOT, "build", "cache", _sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from bench.lib import core, spec  # noqa: E402
from bench.lib import trace as tr  # noqa: E402

TRACE_FILE = os.path.join(ROOT, "build", "bench", "trace.json")


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            smoke: bool = False, t0: float = T0,
            trace_file: str = TRACE_FILE):
    """One run of cell ``name``: (result, checks), or SystemExit where
    JAX or the JAX package is loaded once the window has closed (looked
    for last, after the check and the metric readers have run).
    ``smoke`` runs the CPU tests' sizes on ``device``."""
    import torch
    man = spec.manifest()
    cell = spec.cell(name, man)
    ctx = core.context(name, seed, device, smoke)
    traffic = ctx.traffic
    lim = spec.limits(name, smoke)
    driver = spec.driver_module(traffic["driver"])
    cuda = device.type == "cuda"

    prog = driver.Program(ctx)
    try:
        run = core.Run(cell=name, kind=traffic["driver"])
        run.setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        prog.window(run, seconds)
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                units = prog.traced(traffic["traced_units"])
            os.makedirs(os.path.dirname(trace_file), exist_ok=True)
            prof.export_chrome_trace(trace_file)
            run.traced = tr.summarize(tr.read_chrome_trace(trace_file),
                                      units)
        peak = max(setup_peak, torch.cuda.max_memory_allocated(device)
                   if cuda else 0)
        outputs = prog.outputs()
    finally:
        prog.close()
    del prog

    readings = driver.check(ctx, outputs)
    print(f"check detail: {readings.pop('_where', '')}", file=sys.stderr)
    for k, v in readings.items():
        if k not in lim:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    checks = core.checks_block(readings, lim)
    metrics = {}
    for m in spec.metrics_of(name, trace, man):
        value = spec.metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if run.ttft_s:
        p90 = core.quantile_weighted(run.ttft_s, run.ttft_n, 0.9)
        print(f"ttft detail: {sum(run.ttft_n)} requests in {len(run.ttft_s)}"
              f" batches, {sum(t > p90 for t in run.ttft_s)} batches above "
              "the p90", file=sys.stderr)
    if cuda:
        dev = core.device_info(device, cell["chips"], peak)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if run.traced:
        dev["busy_s"] = run.traced["busy_s"]
        dev["window_s"] = run.traced["window_s"]
    result = {"correct": core.all_pass(checks) and run.failed == 0
              and run.attempted > 0,
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if run.traced:
        result["breakdown"] = {"device_ops": run.traced["top_ops"],
                               "idle_gaps": run.traced["idle_gaps"]}
    if cuda:
        print(f"card: {core.power_limit()}", file=sys.stderr, flush=True)
    found = core.forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} once the window has "
              "closed", file=sys.stderr, flush=True)
        raise SystemExit(3)
    return result, checks


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    chips = spec.cell(args.workload)["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    result, checks = execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0))
    core.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
