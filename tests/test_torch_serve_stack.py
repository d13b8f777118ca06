"""The port's serving facade (``launch/serve_stack``) against the JAX
package's: construction, layer wiring, config validation, the typed
per-batch report and its deprecated views, one census answer through
both stacks, the megascan group route through a host group (one launch
a host group with work), and the whole stack at once — window, planner,
cache, fleet, a scripted crash and live ingest — ending in a census
that equals the exact counts of the final corpus.  Answers are compared
exactly: at rate 1.0 they are counts and doc ids; below it both engines
plan from the same injected probability rows."""
import dataclasses
import json

import numpy as np
import pytest

from _torch_pair import (PKG, both, inject_rows, mixed_queries, port_corpus,
                         port_index, result_record)
from repro_torch.core import pv_dbow as tpv
from repro_torch.core.queries import ExecutionReport
from repro_torch.kernels.megascan import MegascanSpec
from repro_torch.launch import (Ingestor, ServeConfig, ServingStack,
                                build_serving_stack)
from repro_torch.runtime import (BatchWindow, FaultPlan, FleetManager,
                                 HostGroupExecutor, WindowController)
from repro_torch.runtime.budget import RatePlanner
from repro_torch.runtime.qcache import QueryCacheConfig, SemanticQueryCache


@pytest.fixture(scope="module")
def worlds(small_corpus, built_index, tmp_path_factory):
    path = tmp_path_factory.mktemp("stack") / "index.npz"
    return {"jax": (small_corpus, built_index),
            "port": (port_corpus(small_corpus),
                     port_index(built_index, path))}


@pytest.fixture(scope="module")
def rows(worlds):
    corpus, index = worlds["jax"]
    eng = PKG["jax"].queries.QueryBatch(corpus, index)
    return eng._probability_rows(mixed_queries(PKG["jax"]), corpus, index)


def _qs(m):
    return mixed_queries(m)[:3]


@pytest.mark.parametrize("knobs", [
    dict(), dict(hosts=2, replicas=1), dict(hosts=3, replicas=1,
                                            balanced=True),
    dict(cache=True), dict(planner=True, ci=True),
])
def test_census_through_both_stacks(worlds, knobs):
    def run(m):
        corpus, index = worlds[m.name]
        with m.stack.build_serving_stack(corpus, index, **knobs) as stack:
            got = stack.engine.execute(mixed_queries(m), 1.0)
            return dict(res=result_record(got),
                        executor=type(stack.executor).__name__,
                        layers=[getattr(stack, n) is None for n in (
                            "window", "planner", "cache", "fleet",
                            "controller", "ingestor")],
                        gen=stack.generation.record())
    rec = both(run)
    assert rec["res"][0]["value"] == float(
        worlds["port"][0].count_phrase([3]))


def test_default_stack_matches_the_hand_built_engine(worlds, rows):
    def run(m):
        corpus, index = worlds[m.name]
        with m.stack.build_serving_stack(corpus, index) as stack:
            assert isinstance(stack.executor, m.executor.ShardTaskExecutor)
            got = inject_rows(stack.engine, rows).execute(
                mixed_queries(m), 0.4, rng=np.random.default_rng(3))
        with m.executor.ShardTaskExecutor(workers=2) as ex:
            want = inject_rows(m.queries.QueryBatch(corpus, index,
                                                    executor=ex), rows
                               ).execute(mixed_queries(m), 0.4,
                                         rng=np.random.default_rng(3))
        assert result_record(got) == result_record(want)
        return result_record(got)
    both(run)


def test_overrides_topology_fleet_and_cache(worlds):
    corpus, index = worlds["port"]
    cfg = ServeConfig(rate=0.3, workers=1)
    with build_serving_stack(corpus, index, cfg, ci=True) as stack:
        assert stack.config.rate == 0.3 and stack.config.ci is True
        assert stack.engine.ci is True
    assert cfg.ci is False
    with build_serving_stack(corpus, index, hosts=2, replicas=1,
                             fleet=True) as stack:
        assert isinstance(stack.executor, HostGroupExecutor)
        assert isinstance(stack.fleet, FleetManager)
        assert stack.executor.clock is stack.clock is index.clock
        stack.engine.execute(_qs(PKG["port"]), 0.4,
                             rng=np.random.default_rng(3))
        stack.fleet.drain(1)
        assert stack.executor.stats["placement_epoch"] == 1
        assert stack.generation.placement == 1
    with build_serving_stack(
            corpus, index, cache=True,
            cache_config=QueryCacheConfig(max_entries=8, ttl_s=3600.0,
                                          hamming_radius=0)) as stack:
        assert isinstance(stack.cache, SemanticQueryCache)
        assert stack.engine.cache is stack.cache
        first = stack.engine.execute(_qs(PKG["port"]), 0.4,
                                     rng=np.random.default_rng(3))
        again = stack.engine.execute(_qs(PKG["port"]), 0.4,
                                     rng=np.random.default_rng(99))
        assert stack.cache.stats["hits"] == 3
        assert result_record(again) == result_record(first)


def test_planner_window_and_static_mode(worlds):
    corpus, index = worlds["port"]
    with build_serving_stack(corpus, index, planner=True, ci=True,
                             window=True, max_batch=4,
                             max_delay_s=0.001) as stack:
        assert isinstance(stack.planner, RatePlanner)
        assert isinstance(stack.controller, WindowController)
        assert isinstance(stack.window, BatchWindow)
        assert stack.window.controller is stack.controller
        assert stack.engine.accepts_pressure
        res = stack.window.submit(_qs(PKG["port"])[0]).result(timeout=30)
        assert res.estimate is not None
    with pytest.raises(RuntimeError):
        stack.window.submit(_qs(PKG["port"])[0])
    with build_serving_stack(corpus, index, window=True,
                             adaptive=False) as stack:
        assert stack.window is not None and stack.controller is None


def test_config_validation_matches_the_reference(worlds):
    def run(m):
        raised = []
        for kw in (dict(balanced=True), dict(fleet=True),
                   dict(host_fault_hook=lambda h, s: None), dict(workers=0),
                   dict(hosts=-1), dict(hosts=2, replicas=-1)):
            try:
                m.stack.ServeConfig(**kw)
                raised.append(None)
            except ValueError:
                raised.append("ValueError")
        with pytest.raises(TypeError):
            m.stack.build_serving_stack(*worlds[m.name], no_such_knob=1)
        return dict(raised=raised, fields=sorted(
            f for f in m.stack.ServeConfig.__dataclass_fields__))
    rec = both(run)
    assert rec["raised"] == ["ValueError"] * 6


def test_report_and_its_deprecated_views(worlds):
    corpus, index = worlds["port"]
    eng = PKG["port"].queries.QueryBatch(corpus, index)
    assert eng.last_report is None
    assert eng.last_plan is None and eng.last_audit is None
    assert eng.last_budget is None and eng.last_degraded is None
    eng.execute(_qs(PKG["port"]), 0.4, rng=np.random.default_rng(3))
    r = eng.last_report
    assert isinstance(r, ExecutionReport)
    assert r.n_queries == 3 and r.rate == 0.4
    assert [list(p) for p in eng.last_plan] == [list(p) for p in r.plan]
    assert eng.last_audit is r.balance and eng.last_budget is r.budget
    assert eng.last_degraded is r.degraded
    with pytest.raises(AttributeError):
        eng.last_plan = []
    rec = json.loads(json.dumps(r.record()))
    assert rec["n_queries"] == 3
    eng.execute(_qs(PKG["port"])[:1], 0.6, rng=np.random.default_rng(4))
    assert eng.last_report is not r and eng.last_report.rate == 0.6
    stack = build_serving_stack(corpus, index)
    assert isinstance(stack, ServingStack) and stack.corpus is corpus
    assert isinstance(stack.config, ServeConfig)
    stack.close()
    stack.close()


@pytest.mark.parametrize("lsh_mode", ["asym", "sym"])
def test_megascan_group_route_through_a_host_group(worlds, lsh_mode):
    """``map_shard_batch(megakernel=True)`` on a host group: the spec's
    group route runs once a host group with work (on CUDA one launch of
    the megascan kernel of the mode each: row 7 asym, row 8 Hamming),
    bit for bit the per-shard route."""
    corpus, index = worlds["port"]
    doc_index = dataclasses.replace(index, granularity="doc",
                                    lsh_mode=lsh_mode).attach_corpus(corpus)
    vecs = doc_index.query_vectors([[3, 7], [5], [2, 9, 11], [4]])
    plans = [list(range(corpus.n_shards)), [0, 1], [corpus.n_shards - 1],
             list(range(0, corpus.n_shards, 2))]
    with build_serving_stack(corpus, doc_index, hosts=3, replicas=1) as st:
        spec = MegascanSpec(doc_index, vecs)
        assert spec.mode == ("asym" if lsh_mode == "asym" else "hamming")
        group = st.executor.map_shard_batch(corpus, plans, spec.scan_fns(),
                                            megakernel=True)
        hosts_with_work = len(st.executor.placement.split(
            sorted({s for p in plans for s in p})))
        assert spec.stats["group_launches"] == hosts_with_work == 3
        per = st.executor.map_shard_batch(corpus, plans, spec.scan_fns(),
                                          megakernel=False)
    assert group == per
    assert [sorted(g) for g in group] == [sorted(p) for p in plans]


def test_the_whole_stack_with_a_crash_and_live_ingest(worlds, pv_model):
    """Window + planner + cache + fleet + ingest on a balanced 3-host
    group: mixed queries stream through the window while the ingestor
    appends twice (spilling new shards) and a scripted fault plan
    crashes a host; every future resolves, and a final census through
    the stack equals the exact counts of the final corpus under the
    last generation minted."""
    model, jcfg = pv_model
    corpus, index = worlds["port"]
    tmodel = tpv.model_from_arrays(np.asarray(model.word_vecs),
                                   np.asarray(model.doc_vecs), "cpu")
    tcfg = tpv.PVDBOWConfig(**{k: v for k, v in
                               dataclasses.asdict(jcfg).items()
                               if k != "use_kernel"})
    rng = np.random.default_rng(21)
    m = PKG["port"]
    with build_serving_stack(
            corpus, dataclasses.replace(index), hosts=3, replicas=2,
            balanced=True, cache=True, planner=True, window=True, fleet=True,
            allow_partial=True, max_retries=4, ingest=True,
            ingest_model=tmodel, ingest_pv_cfg=tcfg, ingest_infer_steps=2,
            ingest_shard_tokens=1024, ingest_yield_s=0.0) as stack:
        assert isinstance(stack.ingestor, Ingestor)
        plan = FaultPlan(seed=4).crash(1, at_job=3)
        plan.install(stack.executor)
        futs, steps = [], []
        for i in range(24):
            futs.append(stack.window.submit(mixed_queries(m)[i % 6]))
            if i in (6, 14):
                docs = [rng.integers(0, corpus.vocab_size, 30)
                        .astype(np.int32) for _ in range(40)]
                steps.append(stack.ingestor.step(docs))
            if i == 10:
                stack.fleet.crash(1)
        results = [f.result(timeout=120) for f in futs]
        assert len(results) == 24
        assert all(s["appended"] == 40 for s in steps)
        assert sum(s["new_shards"] for s in steps) > 0
        final = stack.corpus
        assert stack.executor.placement.n_shards == final.n_shards
        census = stack.engine.execute(
            [m.queries.BatchQuery.count([w]) for w in (3, 5, 11)], 1.0)
        for w, r in zip((3, 5, 11), census):
            assert r.estimate.value == final.count_phrase([w])
            assert r.shards_read == final.n_shards
        assert stack.generation.record() == steps[-1]["generation"]
        assert stack.generation.content == 2
