"""Traffic is a function of the seed: identical for one seed,
different for another; the prefill mix keeps one set of lengths."""
import numpy as np
import pytest
import torch

from benchtest import CPU, PREFILL, SEED, TRAIN, ctx
from bench.lib import lm
from bench.reference import common as C


@pytest.mark.parametrize("cell", TRAIN)
def test_training_rows_follow_the_seed(cell):
    drv = __import__("bench.drivers.train", fromlist=["_docs"])
    a, b, c = (drv._docs(ctx(cell, s)) for s in (SEED, SEED, SEED + 1))
    t = ctx(cell).traffic
    ra = C.pack_rows(a, 0, t["rows"] * 3, t["seq"])
    rb = C.pack_rows(b, 0, t["rows"] * 3, t["seq"])
    rc = C.pack_rows(c, 0, t["rows"] * 3, t["seq"])
    assert all(np.array_equal(x, y) for x, y in zip(ra, rb))
    assert not np.array_equal(ra[0], rc[0])
    # the check's rows all differ
    rows = {tuple(r) for r in ra[0]}
    assert len(rows) == t["rows"] * 3


@pytest.mark.parametrize("cell", TRAIN)
def test_the_pipeline_packs_as_the_reference_does(cell):
    from repro_torch.data.pipeline import LMBatchPipeline
    from repro_torch.data.store import Document, ShardedCorpus
    drv = __import__("bench.drivers.train", fromlist=["_docs"])
    cx = ctx(cell)
    t = cx.traffic
    docs = drv._docs(cx)
    corpus = ShardedCorpus.from_documents(
        [Document(i, d) for i, d in enumerate(docs)], 256,
        shard_tokens=t["shard_tokens"])
    pipe = LMBatchPipeline(corpus, t["rows"], t["seq"],
                           shard_order=np.arange(corpus.n_shards))
    it = pipe.iter_epoch(0)
    for step in range(3):
        b = next(it)
        tok, lab = C.pack_rows(docs, step * t["rows"], t["rows"], t["seq"])
        assert np.array_equal(b["tokens"], tok)
        assert np.array_equal(b["labels"], lab)


@pytest.mark.parametrize("rows,seq", [(2, 32), (3, 50), (7, 61)])
def test_epoch_batches_count_the_pipelines(rows, seq):
    """The step after the window is packed again from the documents at
    its place in the stream: the pipeline's whole batches of an epoch
    are the reference's rows, and its batch count is the driver's."""
    from repro_torch.data.pipeline import LMBatchPipeline
    from repro_torch.data.store import Document, ShardedCorpus
    drv = __import__("bench.drivers.train", fromlist=["epoch_batches"])
    cell = TRAIN[0]
    docs = drv._docs(ctx(cell))
    corpus = ShardedCorpus.from_documents(
        [Document(i, d) for i, d in enumerate(docs)], 256,
        shard_tokens=ctx(cell).traffic["shard_tokens"])
    pipe = LMBatchPipeline(corpus, rows, seq,
                           shard_order=np.arange(corpus.n_shards))
    got = list(pipe.iter_epoch(0))
    full, per_epoch = drv.epoch_batches(docs, rows, seq)
    assert per_epoch == len(got)
    assert full == sum(bool(b["mask"].all()) for b in got)
    for j in range(full):
        tok, lab = C.pack_rows(docs, j * rows, rows, seq)
        assert np.array_equal(got[j]["tokens"], tok)
        assert np.array_equal(got[j]["labels"], lab)


@pytest.mark.parametrize("cell", TRAIN)
def test_the_window_reads_the_ports_batch_stream(cell, monkeypatch):
    from repro_torch.launch import train as T
    drv = __import__("bench.drivers.train", fromlist=["Program"])
    seen = []
    real = T._batch_stream

    def stream(pipeline, cfg, dev):
        for b in real(pipeline, cfg, dev):
            seen.append(b["tokens"].shape)
            yield b
    monkeypatch.setattr(T, "_batch_stream", stream)
    cx = ctx(cell)
    prog = drv.Program(cx)
    prog.close()
    assert len(seen) >= cx.traffic["check_steps"]
    assert seen[0] == (cx.traffic["rows"], cx.traffic["seq"])


@pytest.mark.parametrize("cell", PREFILL)
def test_prompts_and_order_follow_the_seed(cell):
    drv = __import__("bench.drivers.prefill", fromlist=["Plan"])
    pa, pb, pc = (drv.Plan(ctx(cell, s)) for s in (SEED, SEED, SEED + 1))
    n = 3 * len(pa.lengths)
    sa = [pa.batch(i) for i in range(n)]
    assert sa == [pb.batch(i) for i in range(n)]
    assert sa != [pc.batch(i) for i in range(n)]
    # every seed does the same work: each cycle is the same set
    k = len(pa.lengths)
    for p in (pa, pc):
        for c in range(3):
            got = sorted(p.batch(c * k + j)[0] for j in range(k))
            assert got == sorted(pa.lengths)
    cdf = torch.tensor(lm.zipf_cdf(256))
    x = lm.prompt_tokens(SEED, 0, 4, 3, 16, cdf, CPU)
    assert torch.equal(x, lm.prompt_tokens(SEED, 0, 4, 3, 16, cdf, CPU))
    assert not torch.equal(x, lm.prompt_tokens(SEED + 1, 0, 4, 3, 16, cdf,
                                               CPU))
    assert not torch.equal(x, lm.prompt_tokens(SEED, 1, 4, 3, 16, cdf, CPU))
    assert int(x.max()) < 256


def test_full_size_lengths_and_budgets():
    drv = __import__("bench.drivers.prefill", fromlist=["Plan"])
    from bench.lib import spec
    for cell in PREFILL:
        t = spec.traffic(spec.cell(cell)["traffic"])
        g = t["lengths"]
        ls = lm.prompt_lengths(g["n"], g["median"], g["sigma"], g["min"],
                               g["max"])
        assert g["min"] <= min(ls) < g["median"] < max(ls) <= g["max"]
        assert sorted(ls)[len(ls) // 2] >= g["median"] * 0.8
        plan = drv.Plan(ctx(cell))
        plan.budget = t["tokens_per_batch"]
        for x, rows in ((x, plan.rows(x)) for x in ls):
            assert rows * x <= t["tokens_per_batch"]


def test_weights_follow_the_seed():
    leaves = [("a", (3, 4), ("normal", 0.02)), ("b", (5,), ("const", 1.0)),
              ("c", (2, 6), ("uniform", -0.5, 0.5))]
    a = lm.make_weights(leaves, SEED, CPU)
    b = lm.make_weights(leaves, SEED, CPU)
    c = lm.make_weights(leaves, SEED + 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["a"], c["a"])
    assert float(a["c"].abs().max()) <= 0.5
    assert torch.equal(a["b"], torch.ones(5))


@pytest.mark.parametrize("cell", PREFILL)
def test_a_prefill_window_holds_whole_cycles(cell):
    from bench.lib import core
    drv = __import__("bench.drivers.prefill", fromlist=["Program"])
    cx = ctx(cell)
    prog = drv.Program(cx, warm=False)
    run = core.Run(cell=cell, kind="prefill")
    prog.window(run, 0.0)
    prog.close()
    n = len(prog.plan.lengths)
    assert run.units == n
    assert sorted(d[1] for d in prog.done) == sorted(prog.plan.lengths)
