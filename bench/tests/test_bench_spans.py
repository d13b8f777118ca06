"""The attribution of device time to the program's spans
(``bench/lib/spans.py``) on a hand-built trace, the metrics that read
it, and their silence on a trace without spans or of another run."""
import json

import pytest

from benchtest import execute
from bench.lib import core, spec, spans
from bench.lib import trace as tr

MAIN, DEV, WORKER = 1, 2, 3     # threads: the step's, autograd's, the loader's
UNITS = 2


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _span(name, tid, a, b):
    return _x("user_annotation", name, tid, a, b - a)


def _launch(c, tid, ts):
    return _x("cuda_runtime", "cudaLaunchKernel", tid, ts, 1,
              correlation=c)


def _kernel(c, a, b, cat="kernel", ext=None):
    args = {"correlation": c}
    if ext is not None:
        args["External id"] = ext
    return _x(cat, f"k{c}", 7, a, b - a, **args)


def _flow(ph, fid, tid, ts):
    e = {"ph": ph, "cat": "fwdbwd", "name": "fwdbwd", "id": fid, "pid": 0,
         "tid": tid, "ts": ts}
    if ph == "f":
        e["bp"] = "e"
    return e


def _node(name, fid, evaluate, node):
    """An autograd node on the device thread: the engine's
    evaluate_function event around the node, whose start ends the
    flow from its forward operator."""
    return [_x("cpu_op", f"{spans.NODE}: {name}", DEV, *evaluate),
            _x("cpu_op", name, DEV, *node), _flow("f", fid, DEV, node[0])]


def hand_trace():
    """Two traced units in one 1000 us window (times in us).  Forward
    on the main thread; backward on the autograd's device thread, one
    layer recomputed inside a node; the optimizer; a state set-up with
    the device idle; the loader's copy from an unprofiled thread."""
    ev = [_span(tr.WINDOW, MAIN, 0, 1000),
          _span("data.wait", MAIN, 2, 8),
          _span("train.forward", MAIN, 10, 300),
          _span("model.cast", MAIN, 20, 40),
          _span("model.layer", MAIN, 50, 200),
          _span("layer.attention", MAIN, 60, 120),
          _span("model.head", MAIN, 210, 240),
          _span("model.loss", MAIN, 250, 290),
          _span("train.backward", MAIN, 300, 800),
          _span("train.optimizer", MAIN, 800, 900),
          _span("serve.init_state", MAIN, 905, 980),
          _span("data.wait", MAIN, 962, 966),
          _span("bench.train_step", MAIN, 9, 901)]
    # forward operators, each the start of a flow to its backward node
    for fid, name, ts in ((1, "aten::_to_copy", 25), (2, "aten::bmm", 70),
                          (3, "aten::mm", 150), (4, "aten::mm", 220)):
        ev += [_x("cpu_op", name, MAIN, ts, 5), _flow("s", fid, MAIN, ts)]
    # forward kernels: cast 10, attention 40, mlp 20, head 10, and the
    # loss's 8, found by its operator's External id (no runtime event)
    ev += [_launch(101, MAIN, 26), _kernel(101, 30, 40),
           _launch(102, MAIN, 72), _kernel(102, 80, 120),
           _launch(103, MAIN, 152), _kernel(103, 155, 175),
           _launch(104, MAIN, 222), _kernel(104, 225, 235),
           _x("cpu_op", "aten::log_softmax", MAIN, 260, 5,
              **{"External id": 555}),
           _kernel(999, 262, 270, ext=555)]
    # backward: the head's node (its kernel, then the add of its output
    # into the next node's input, outside the node); the mlp's node,
    # inside which the layer is recomputed; the attention's; the cast's
    ev += _node("MmBackward0", 4, (320, 40), (322, 28))
    ev += [_launch(201, DEV, 330), _kernel(201, 330, 350),
           _launch(202, DEV, 355), _kernel(202, 352, 357)]
    ev += _node("MmBackward0", 3, (400, 200), (401, 189))
    ev += [_span("model.layer", DEV, 410, 500),
           _span("layer.attention", DEV, 420, 460),
           _launch(203, DEV, 430), _kernel(203, 430, 450),
           _launch(204, DEV, 480), _kernel(204, 470, 490),
           _launch(205, DEV, 550), _kernel(205, 550, 570)]
    ev += _node("BmmBackward0", 2, (610, 90), (611, 79))
    ev += [_launch(206, DEV, 620), _kernel(206, 620, 660)]
    ev += _node("ToCopyBackward0", 1, (710, 30), (711, 19))
    ev += [_launch(207, DEV, 715), _kernel(207, 715, 725),
           # the device thread outside any node; the unused leaves' zeros
           _launch(208, DEV, 750), _kernel(208, 750, 755),
           _launch(106, MAIN, 790), _kernel(106, 790, 794)]
    # the optimizer; the state's fill; a kernel cut by the window's end,
    # one after it; the loader's copy
    ev += [_launch(105, MAIN, 810), _kernel(105, 815, 845),
           _launch(108, MAIN, 910), _kernel(108, 912, 922, "gpu_memset"),
           _launch(109, MAIN, 985), _kernel(109, 995, 1010),
           _launch(110, MAIN, 990), _kernel(110, 1000, 1010),
           _launch(301, WORKER, 500), _kernel(301, 500, 502, "gpu_memcpy")]
    return ev


# by hand, in us over the window: forward 10+40+20+10+8; backward
# 20+5+20+20+20+40+10+5+4, of it recomputed 20+20 and linked to a
# forward span 20+5+20+40+10; attention 40 (forward) + 20 (recomputed)
# + 40 (its node); head and loss 10+8+20+5; cast 10+10; the copy and
# the cut kernel (5 of 15) under no span; init_state 75 long, 10 busy
WANT_US = {"forward_s": 88, "backward_s": 144, "recompute_s": 40,
           "linked_s": 95, "optimizer_s": 30, "attention_s": 100,
           "head_loss_s": 43, "cast_s": 20, "unattributed_s": 7,
           "busy_s": 279, "device_s": 279, "init_state_idle_s": 65,
           "data_wait_s": 10}
WANT_MS = {"forward_ms.train": 0.044, "backward_ms.train": 0.072,
           "recompute_ms.train": 0.020, "optimizer_ms.train": 0.015,
           "attention_ms.train": 0.050, "head_loss_ms.train": 0.0215,
           "cast_ms.train": 0.010, "queue_wait_ms.train": 0.005,
           "attention_ms.prefill": 0.050,
           "init_state_idle_ms.prefill": 0.0325}


def test_attribution_by_hand():
    got = spans.attribute(hand_trace(), UNITS)
    for k, us in WANT_US.items():
        assert got[k] == pytest.approx(us * 1e-6, abs=1e-12), k
    assert got["device_ops"] == 18
    assert got["data_waits"] == 2 and got["init_states"] == 1
    assert set(got["present"]) == set(spans.SPANS)
    s = tr.summarize(hand_trace(), UNITS)
    assert (got["window_s"], got["device_ops"]) == (s["window_s"],
                                                    s["device_ops"])
    assert got["busy_s"] == pytest.approx(s["busy_s"])


def _run(kind, events, path, monkeypatch):
    path.write_text(json.dumps({"traceEvents": events}))
    monkeypatch.setattr(spans, "TRACE_FILE", path)
    run = core.Run(cell=f"smollm-360m.{kind}", kind=kind)
    run.traced = tr.summarize(events, UNITS)
    return run


NEW = sorted(WANT_MS)


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_by_hand(name, tmp_path, monkeypatch):
    kind = name.rsplit(".", 1)[1]
    run = _run(kind, hand_trace(), tmp_path / "trace.json", monkeypatch)
    assert spec.metric_module(name).read(run) == pytest.approx(
        WANT_MS[name], abs=1e-12)
    other = core.Run(cell=run.cell, kind="prefill" if kind == "train"
                     else "train", traced=run.traced)
    assert spec.metric_module(name).read(other) is None


@pytest.mark.parametrize("name", NEW)
def test_silent_without_spans_or_with_another_runs_trace(
        name, tmp_path, monkeypatch):
    """A program that opens no spans (the trace holds the benchmark's
    annotations alone), no trace file, or a file of another run: no
    value, and no error."""
    kind = name.rsplit(".", 1)[1]
    bare = [e for e in hand_trace() if e.get("cat") != "user_annotation"
            or not e["name"] in spans.SPANS]
    run = _run(kind, bare, tmp_path / "bare.json", monkeypatch)
    assert spec.metric_module(name).read(run) is None
    run = _run(kind, hand_trace(), tmp_path / "trace.json", monkeypatch)
    run.traced = dict(run.traced, window_s=run.traced["window_s"] * 2)
    assert spec.metric_module(name).read(run) is None
    monkeypatch.setattr(spans, "TRACE_FILE", tmp_path / "absent.json")
    assert spec.metric_module(name).read(run) is None
    run = _run(kind, hand_trace(), tmp_path / "trace.json", monkeypatch)
    monkeypatch.setattr(spans, "SPANS", ())     # the program has no spans
    assert spec.metric_module(name).read(run) is None


@pytest.mark.parametrize("match", [True, False])
def test_the_trace_is_parsed_once_a_run(match, tmp_path, monkeypatch):
    """Ten readers, one parse: the first keeps what it read (or that
    the file was another run's) on the run."""
    calls = []
    real = spans.read
    monkeypatch.setattr(spans, "read",
                        lambda *a: calls.append(a) or real(*a))
    run = _run("train", hand_trace(), tmp_path / "trace.json", monkeypatch)
    if not match:
        run.traced = dict(run.traced, device_ops=run.traced["device_ops"] + 1)
    got = {n: spec.metric_module(n).read(run) for n in NEW}
    assert len(calls) == 1
    assert all((v is not None) == (match and n.endswith(".train"))
               for n, v in got.items())


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_a_traced_run_reports_the_span_metrics(kind, tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "TRACE_FILE", tmp_path / "trace.json")
    cell = f"smollm-360m.{kind}"
    result, _ = execute(cell, tmp_path, trace=True)
    want = {m for m in NEW if m.endswith("." + kind)}
    assert want <= set(result["metrics"])
    assert want <= {m["name"] for m in spec.metrics_of(cell, True)}
    assert result["correct"]


def test_the_script_prints_the_shares(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": hand_trace()}))
    assert spans.main([str(path), "--units", str(UNITS)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["ms_a_unit"]["attention"] == pytest.approx(0.050)
    sh = out["shares"]
    assert sh["phases_of_busy"] == pytest.approx((88 + 144 + 30) / 279)
    assert sh["unattributed_of_busy"] == pytest.approx(7 / 279)
    assert sh["linked_of_backward_less_recompute"] == pytest.approx(95 / 104)
    assert sh["recompute_of_forward"] == pytest.approx(40 / 88)
