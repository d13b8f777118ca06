"""Device time a prefill batch spends in the port's fused attention
kernel (``repro_torch/kernels/attention``): the kernels of the traced
window whose name holds ``SYMBOL``, clipped to the window, over the
traced batches.  Read from the trace run.py wrote (``spans.TRACE_FILE``,
parsed once more); 0 where the window launched none.  No value for a
run of another kind, with no traced segment, for a program without the
kernel, or where the file is another run's (its window or count of
device operations differs from the run's summary)."""
import gc
import importlib.util

from bench.lib import spans
from bench.lib import trace as tr

SYMBOL = "fused_attention_fwd"
PACKAGE = "repro_torch.kernels.attention"


def kernel_s(events):
    """(window_s, device operations in it, seconds of ``SYMBOL``'s
    kernels in it) of a Chrome trace's events."""
    win = next((e for e in events if e.get("ph") == "X"
                and e.get("name") == tr.WINDOW
                and e.get("cat") == "user_annotation"), None)
    if win is None:
        raise ValueError(f"the trace holds no {tr.WINDOW!r} span")
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    n_ops, us = 0, 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in tr.DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        n_ops += 1
        if e.get("cat") == "kernel" and SYMBOL in e.get("name", ""):
            us += b - a
    return (w1 - w0) * 1e-6, n_ops, us * 1e-6


def read(run):
    t = run.traced
    if run.kind != "prefill" or not t or t["units"] <= 0:
        return None
    try:
        if importlib.util.find_spec(PACKAGE) is None:
            return None
    except ModuleNotFoundError:
        return None
    was = gc.isenabled()
    gc.disable()
    try:
        window_s, n_ops, s = kernel_s(tr.read_chrome_trace(spans.TRACE_FILE))
    except (OSError, ValueError):
        return None
    finally:
        if was:
            gc.enable()
    if (window_s, n_ops) != (t["window_s"], t["device_ops"]):
        return None
    return 1e3 * s / t["units"]
