"""The port's serving runtime (placement, balance, budget, controller,
window, fleet, chaos) against the JAX package's, scenario by scenario.

The runtime is numpy and threads in both packages, so every scenario
runs once through each (``_torch_pair.both``) on the same inputs and
event sequences and the records must be equal exactly: plans, splits,
audit records, controller decisions, fault decisions, stats.  Walls
measured on the host clock are never compared; where a scenario's
control input is a wall (a slow host), the port runs it alone and is
held to the JAX test's invariants.  End-to-end cases serve the same
corpus and index through both engines: at rate 1.0 (a census) the
answers are equal, and below 1.0 both engines plan from the same
injected probability rows, so the sampled plans and estimates are
equal bit for bit (numpy's RNG drives both samplers)."""
import json
import math
import threading
import time

import numpy as np
import pytest

from _torch_pair import (PKG, FakeCorpus, both, inject_rows, mixed_queries,
                         port_corpus, port_index, plain, result_record)


@pytest.fixture(scope="module")
def worlds(small_corpus, built_index, tmp_path_factory):
    """{"jax": (corpus, index), "port": (corpus, index)} over the same
    documents, shards and index arrays."""
    path = tmp_path_factory.mktemp("rt") / "index.npz"
    return {"jax": (small_corpus, built_index),
            "port": (port_corpus(small_corpus),
                     port_index(built_index, path))}


@pytest.fixture(scope="module")
def rows(worlds):
    """The JAX engine's probability rows for ``mixed_queries``, injected
    into both engines below rate 1.0."""
    corpus, index = worlds["jax"]
    eng = PKG["jax"].queries.QueryBatch(corpus, index)
    return eng._probability_rows(mixed_queries(PKG["jax"]), corpus, index)


# ----------------------------------------------------------------------
# placement: PlacementMap
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ctor,args", [
    ("blocked", (16, 4, 1)), ("blocked", (8, 2, 5)), ("blocked", (8, 2, 0)),
    ("round_robin", (10, 3, 2)), ("blocked", (7, 3, 2)),
])
def test_placement_constructors(ctor, args):
    def run(m):
        pm = getattr(m.placement.PlacementMap, ctor)(*args[:2],
                                                     n_replicas=args[2])
        return dict(primary=pm.primary, replicas=pm.replicas,
                    n=(pm.n_shards, pm.n_hosts, pm.n_replicas),
                    hosts=[pm.hosts_of(s) for s in range(pm.n_shards)],
                    on=[pm.shards_on(h) for h in range(pm.n_hosts)])
    rec = both(run)
    for hosts in rec["hosts"]:
        assert len(set(hosts)) == len(hosts)        # replicas distinct


def test_placement_split_failover_and_extend():
    def run(m):
        pm = m.placement.PlacementMap.blocked(8, 2, n_replicas=1)
        out = dict(split=pm.split([0, 5, 2, 7]),
                   failover=pm.split([0, 5], dead=frozenset({0})))
        for dead, p in ((frozenset({0, 1}), pm),
                        (frozenset({0}), m.placement.PlacementMap.blocked(
                            8, 2, n_replicas=0))):
            with pytest.raises(m.placement.HostFailure):
                p.split([1], dead=dead)
        orphans = []
        out["partial"] = pm.split([0, 1, 6], dead=frozenset({0, 1}),
                                  orphans=orphans)
        out["orphans"] = orphans
        grown = m.placement.PlacementMap.blocked(6, 2, n_replicas=1).extend(9)
        out["grown"] = (grown.primary, grown.replicas)
        assert pm.extend(8) is pm
        with pytest.raises(ValueError):
            pm.extend(3)
        for bad in (lambda: m.placement.PlacementMap(
                        np.asarray([0, 5]), np.zeros((2, 0), np.int64), 2),
                    lambda: m.placement.PlacementMap(
                        np.asarray([0, 1]), np.asarray([[0], [0]]), 2),
                    lambda: m.placement.PlacementMap.blocked(4, 0)):
            with pytest.raises(ValueError):
                bad()
        return out
    rec = both(run)
    assert rec["split"] == {0: [0, 2], 1: [5, 7]}
    assert rec["grown"][0][:6] == [0, 0, 0, 1, 1, 1]


def test_from_mesh_takes_the_host_count():
    """The port's ``from_mesh`` takes the data host count from a mesh,
    the product of its residency axes (pod x data), as the JAX one
    does, and lays shards out as ``blocked``; a bare count is refused."""
    from repro.runtime.placement import PlacementMap as J
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch.mesh import make_placement_mesh
    from repro_torch.runtime.placement import PlacementMap as T
    for hosts, shards in ((4, 10), (6, 12), (1, 3)):
        got = T.from_mesh(make_placement_mesh(hosts), shards)
        want = J.blocked(shards, hosts)
        assert plain((got.primary, got.replicas, got.n_hosts)) == \
            plain((want.primary, want.replicas, want.n_hosts))
    pod = T.from_mesh(AbstractMesh((2, 3, 4), ("pod", "data", "model")), 12)
    assert plain((pod.primary, pod.n_hosts)) == \
        plain((J.blocked(12, 6).primary, 6))
    with pytest.raises(TypeError):
        T.from_mesh(4, 4)


# ----------------------------------------------------------------------
# placement: HostGroupExecutor
# ----------------------------------------------------------------------
def test_host_group_gather_matches_single_executor():
    def run(m):
        pm = m.placement.PlacementMap.blocked(12, 3, n_replicas=1)
        with m.placement.HostGroupExecutor(pm, workers_per_host=2) as hg, \
                m.executor.ShardTaskExecutor(workers=2) as single:
            got = hg.map_shards(FakeCorpus(12), range(12),
                                lambda s: s.shard_id * 3)
            want = single.map_shards(FakeCorpus(12), range(12),
                                     lambda s: s.shard_id * 3)
            assert got == want
            plan = [[0, 1, 6], [1, 6, 7], [2]]
            fns = [lambda s, q=q: (q, s.shard_id) for q in range(3)]
            batch = hg.map_shard_batch(FakeCorpus(12), plan, fns)
            assert batch == single.map_shard_batch(FakeCorpus(12), plan, fns)
            return dict(got=sorted(got.items()), batch=batch,
                        split=hg.residency_split(plan),
                        stats={k: hg.stats[k] for k in (
                            "jobs", "host_jobs", "host_failures",
                            "scans_per_host")},
                        job=(hg.last_job["tasks"], hg.last_job["hosts"]))
    rec = both(run)
    assert rec["split"] == {0: 3, 1: 2}
    assert rec["job"] == [5.0, 2.0]


def test_host_failure_requeues_on_replica_and_chains_the_cause():
    def run(m):
        downed = []

        def host_fault(host, shard_ids):
            if host == 0 and not downed:
                downed.append(list(shard_ids))
                raise RuntimeError("injected host fault")

        pm = m.placement.PlacementMap.blocked(10, 2, n_replicas=1)
        with m.placement.HostGroupExecutor(
                pm, workers_per_host=1, host_fault_hook=host_fault) as hg:
            out = hg.map_shards(FakeCorpus(10), range(10),
                                lambda s: s.shard_id + 100)
        rec = dict(out=sorted(out.items()), downed=downed,
                   stats={k: hg.stats[k] for k in (
                       "host_failures", "requeued_shards",
                       "scans_per_host")})

        def gone(host, shard_ids):
            if host == 1:
                raise RuntimeError("host 1 is gone")

        pm0 = m.placement.PlacementMap.blocked(6, 2, n_replicas=0)
        with m.placement.HostGroupExecutor(pm0, workers_per_host=1,
                                           host_fault_hook=gone) as hg:
            with pytest.raises(m.placement.HostFailure) as exc:
                hg.map_shards(FakeCorpus(6), range(6), lambda s: s.shard_id)
        rec["cause"] = str(exc.value.__cause__)
        rec["orphans"] = exc.value.shard_ids
        return rec
    rec = both(run)
    assert rec["downed"] == [[0, 1, 2, 3, 4]]
    assert rec["stats"]["scans_per_host"] == [0, 10]
    assert rec["cause"] == "host 1 is gone"


def test_task_faults_stay_inside_the_host_and_close_is_idempotent():
    def run(m):
        fails = {3: 1}

        def hook(sid, attempt):
            if fails.get(sid, 0) >= attempt:
                raise RuntimeError("transient task fault")

        pm = m.placement.PlacementMap.blocked(8, 2, n_replicas=1)
        with m.placement.HostGroupExecutor(pm, workers_per_host=2,
                                           max_retries=2,
                                           fault_hook=hook) as hg:
            out = hg.map_shards(FakeCorpus(8), range(8), lambda s: s.shard_id)
        hg.close()
        return dict(out=sorted(out.items()),
                    failures=hg.stats["host_failures"],
                    retries=sum(ex.stats["retries"]
                                for ex in hg.hosts.values()),
                    closed=all(ex._pool is None for ex in hg.hosts.values()))
    rec = both(run)
    assert rec["failures"] == 0 and rec["retries"] == 1 and rec["closed"]


@pytest.mark.parametrize("rate", [0.4, 1.0])
def test_engine_through_a_host_group_matches_the_reference(worlds, rows,
                                                           rate):
    """The same batch through a 2-host group in each package: equal to
    each other and to the package's single executor; the per-host scans
    equal the residency split of the executed plan."""
    def run(m):
        corpus, index = worlds[m.name]
        pm = m.placement.PlacementMap.blocked(corpus.n_shards, 2,
                                              n_replicas=1)
        with m.executor.ShardTaskExecutor(workers=2) as single, \
                m.placement.HostGroupExecutor(pm, workers_per_host=1) as hg:
            ref = m.queries.QueryBatch(corpus, index, executor=single)
            eng = m.queries.QueryBatch(corpus, index, executor=hg)
            if rate < 1.0:
                inject_rows(ref, rows)
                inject_rows(eng, rows)
            want = ref.execute(mixed_queries(m), rate,
                               rng=np.random.default_rng(42))
            got = eng.execute(mixed_queries(m), rate,
                              rng=np.random.default_rng(42))
            assert result_record(got) == result_record(want)
            split = hg.residency_split(eng.last_plan)
            observed = {h: c for h, c in
                        enumerate(hg.stats["scans_per_host"]) if c}
            assert observed == split
            return dict(results=result_record(got), split=split,
                        plan=eng.last_plan)
    both(run)


def test_engine_survives_a_host_fault_bit_for_bit(worlds, rows):
    def run(m):
        corpus, index = worlds[m.name]
        downed = []

        def host_fault(host, shard_ids):
            if host == 1 and not downed:
                downed.append(host)
                raise RuntimeError("host 1 down")

        pm = m.placement.PlacementMap.blocked(corpus.n_shards, 2,
                                              n_replicas=1)
        with m.placement.HostGroupExecutor(
                pm, workers_per_host=1, host_fault_hook=host_fault) as hg:
            eng = inject_rows(m.queries.QueryBatch(corpus, index,
                                                   executor=hg), rows)
            got = eng.execute(mixed_queries(m), 0.5,
                              rng=np.random.default_rng(7))
        want = inject_rows(m.queries.QueryBatch(corpus, index), rows).execute(
            mixed_queries(m), 0.5, rng=np.random.default_rng(7))
        assert result_record(got) == result_record(want)
        return dict(results=result_record(got), downed=downed,
                    failures=hg.stats["host_failures"],
                    replica_scans=hg.stats["scans_per_host"])
    rec = both(run)
    assert rec["downed"] == [1] and rec["replica_scans"][1] == 0


# ----------------------------------------------------------------------
# balance
# ----------------------------------------------------------------------
def _hot_model(m, hot_cost=0.2, cold_cost=0.01, n_hosts=2):
    model = m.balance.HostLoadModel(n_hosts)
    model.observe(0, hot_cost * 4, 4)
    for h in range(1, n_hosts):
        model.observe(h, cold_cost * 4, 4)
    return model


def test_load_model_telemetry_and_validation():
    def run(m):
        b = m.balance
        cold = b.HostLoadModel(3)
        pm = m.placement.PlacementMap.blocked(12, 3, n_replicas=1)
        audit = b.plan_split(pm, range(12), cold)
        assert audit.groups == pm.split(range(12))
        model = b.HostLoadModel(3, b.BalanceConfig(ewma_alpha=0.5))
        costs = []
        model.observe(0, 1.0, 10)
        costs.append([model.shard_cost(h) for h in range(3)])
        model.observe(0, 2.0, 10)
        model.observe(1, 0.1, 10)
        costs.append([model.shard_cost(h) for h in range(3)])
        model.ensure_hosts(4)
        model.forget_host(0)
        costs.append([model.shard_cost(h) for h in range(4)])
        for bad in (lambda: b.HostLoadModel(0),
                    lambda: b.BalanceConfig(ewma_alpha=0.0),
                    lambda: b.BalanceConfig(hysteresis=-0.1)):
            with pytest.raises(ValueError):
                bad()
        noop = b.HostLoadModel(2)
        noop.observe(0, 1.0, 0)
        return dict(cold=[cold.shard_cost(h) for h in range(3)],
                    costs=costs, snapshot=model.snapshot(),
                    noop=noop.snapshot())
    rec = both(run)
    assert rec["costs"][0][0] == pytest.approx(0.1)
    assert rec["costs"][1][0] == pytest.approx(0.15)
    assert rec["noop"] == [None, None]


@pytest.mark.parametrize("scenario", ["hot_primary", "ring_replica",
                                      "near_equal", "stateful_band",
                                      "churn", "dead_primary"])
def test_plan_split_scenarios(scenario):
    def run(m):
        b, P = m.balance, m.placement.PlacementMap
        if scenario == "hot_primary":
            pm, model = P.blocked(16, 2, n_replicas=1), _hot_model(m)
            audits = [b.plan_split(pm, range(16), model)]
            assert pm.split(range(16), load=model) == audits[0].groups
        elif scenario == "ring_replica":
            pm, model = P.blocked(16, 4, n_replicas=1), b.HostLoadModel(4)
            model.observe(0, 4.0, 4)
            for h in (1, 2, 3):
                model.observe(h, 0.04, 4)
            audits = [b.plan_split(pm, range(16), model)]
        elif scenario == "near_equal":
            pm = P.blocked(16, 2, n_replicas=1)
            model = b.HostLoadModel(2, b.BalanceConfig(hysteresis=0.25))
            model.observe(0, 0.44, 4)
            model.observe(1, 0.40, 4)
            audits = [b.plan_split(pm, range(16), model) for _ in range(3)]
        elif scenario == "stateful_band":
            pm = P.blocked(16, 2, n_replicas=1)
            cfg = b.BalanceConfig(hysteresis=0.25, stay_fraction=0.5,
                                  ewma_alpha=1.0)
            model, fresh = b.HostLoadModel(2, cfg), b.HostLoadModel(2, cfg)
            audits = []
            for mod, ratio in ((model, 20.0), (model, 1.37), (fresh, 1.37),
                               (model, 1.0)):
                mod.observe(0, 0.1 * ratio * 4, 4)
                mod.observe(1, 0.1 * 4, 4)
                audits.append(b.plan_split(pm, range(16), mod))
            assert [a.balanced for a in audits] == [True, True, False, False]
        elif scenario == "churn":
            pm = P.blocked(16, 2, n_replicas=1)
            model = b.HostLoadModel(2, b.BalanceConfig(ewma_alpha=1.0))
            model.observe(0, 0.3 * 4, 4)
            model.observe(1, 0.1 * 4, 4)
            audits = [b.plan_split(pm, range(16), model)]
        else:
            pm, ids, dead = P.blocked(16, 2, n_replicas=1), [3, 0, 9, 12, 5], \
                frozenset({0})
            audits = [b.plan_split(pm, ids, mod, dead=dead)
                      for mod in (b.HostLoadModel(2), _hot_model(m),
                                  _hot_model(m, 0.01, 0.2))]
            for a in audits:
                assert a.groups == pm.split(ids, dead)
            with pytest.raises(m.placement.HostFailure):
                pm.split(ids, frozenset({0, 1}), load=_hot_model(m))
        for a in audits:      # residency kept: every shard on a holder
            for h, g in a.groups.items():
                assert all(h in pm.hosts_of(s) for s in g)
        return [dict(a.record(), groups=a.groups, base=a.base_groups)
                for a in audits]
    rec = both(run)
    if scenario == "hot_primary":
        assert rec[0]["balanced"] and rec[0]["shed"] > 0
    if scenario == "near_equal":
        assert not any(a["balanced"] for a in rec)


def test_balanced_host_group_requeue_is_read_only_on_the_band():
    def run(m):
        pm = m.placement.PlacementMap.blocked(16, 2, n_replicas=1)
        model = _hot_model(m)
        assert m.balance.plan_split(pm, range(16), model).balanced
        died = []

        def fault(host, shard_ids):
            if host == 1 and not died:
                died.append(host)
                raise RuntimeError("host 1 down")

        with m.placement.HostGroupExecutor(pm, workers_per_host=1,
                                           balancer=model,
                                           host_fault_hook=fault) as hg:
            out = hg.map_shards(FakeCorpus(16), range(16), lambda s: 1)
            bal = hg.last_job["balance"]
        assert model.balanced_mode
        assert hg.stats["shed_shards"] == bal["shed"]

        def down0(host, shard_ids):
            if host == 0:
                raise RuntimeError("host 0 down")

        with m.placement.HostGroupExecutor(
                m.placement.PlacementMap.blocked(10, 2, n_replicas=1),
                workers_per_host=1, balanced=True,
                host_fault_hook=down0) as hg2:
            out2 = hg2.map_shards(FakeCorpus(10), range(10),
                                  lambda s: s.shard_id + 1)
        with m.placement.HostGroupExecutor(pm, workers_per_host=1) as hg3:
            hg3.map_shards(FakeCorpus(8), range(8), lambda s: 0)
            assert "balance" not in hg3.last_job
        return dict(n=len(out), died=died, shed=bal["shed"],
                    groups=bal["group_sizes"], base=bal["base_group_sizes"],
                    out2=sorted(out2.items()),
                    scans2=hg2.stats["scans_per_host"])
    rec = both(run)
    assert rec["scans2"] == [0, 10]


def test_balanced_host_group_learns_a_slow_host():
    """Port only (the input is a measured wall): a host 5 ms a shard
    slower sheds after the first job, residency kept, every shard
    gathered."""
    m = PKG["port"]
    pm = m.placement.PlacementMap.blocked(16, 2, n_replicas=1)

    def hot(host, shard_ids):
        if host == 0:
            time.sleep(0.005 * len(shard_ids))

    with m.placement.HostGroupExecutor(pm, workers_per_host=1,
                                       balanced=True,
                                       host_fault_hook=hot) as hg:
        for _ in range(3):
            out = hg.map_shards(FakeCorpus(16), range(16),
                                lambda s: s.shard_id)
            assert out == {i: i for i in range(16)}
        rec = hg.last_job["balance"]
    assert hg.stats["shed_shards"] > 0
    assert rec["balanced"] and rec["group_sizes"][0] < rec["base_group_sizes"][0]
    assert sum(rec["realized_group_sizes"]) == 16


# ----------------------------------------------------------------------
# budget
# ----------------------------------------------------------------------
class _Q:
    def __init__(self, kind="count", budget=None):
        self.kind, self.budget = kind, budget


def test_budget_validation():
    def run(m):
        B, C, R = (m.budget.QueryBudget, m.budget.PlannerConfig,
                   m.budget.RatePlanner)
        raised = []
        for bad in (lambda: B(), lambda: B(max_rel_error=0.0),
                    lambda: B(max_rel_error=0.1, floor_rate=0.0),
                    lambda: B(max_latency_s=-1.0),
                    lambda: C(default_floor_rate=0.0),
                    lambda: R(0)):
            try:
                bad()
                raised.append(None)
            except ValueError:
                raised.append("ValueError")
        return raised
    rec = both(run)
    assert rec.count("ValueError") >= 5


def test_error_curve_and_rate_planning():
    def run(m):
        B, R = m.budget.QueryBudget, m.budget.RatePlanner
        planner = R(64)
        curve = planner.curve("count")
        out = dict(seed=curve.scale(),
                   predict=[curve.predict(n) for n in (1, 2, 8, 64)],
                   need=[curve.required_n(t, 0.95, 64)
                         for t in (0.3, 0.5, 0.9, 1e-9)])
        curve.observe(1, 0.5)
        curve.observe(8, float("inf"))
        curve.observe(8, 0.0)
        out["degenerate"] = (curve.s_rel, curve.count)
        curve.observe(8, 0.3)
        out["learned"] = (curve.scale(), curve.predict(8))
        p20 = R(20)
        p20.curve("count").observe(10, 0.2)
        out["rates"] = [
            p20.plan_rate("count", None, 0.5),
            p20.plan_rate("count", B(max_rel_error=0.25, floor_rate=0.05), 0.5),
            p20.plan_rate("count", B(max_rel_error=0.1, floor_rate=0.05), 0.5),
            p20.plan_rate("count", B(max_rel_error=5.0, floor_rate=0.3), 0.5),
            p20.plan_rate("count", B(max_rel_error=1e-9), 0.5),
            R(16).plan_rate("count", B(max_latency_s=0.01, floor_rate=0.05),
                            0.4)]

        class _Plan:
            est_p99_s = 0.1

        class _Ctl:
            current_plan = _Plan()

        capped = R(16, controller=_Ctl())
        capped._ref_rate = 0.4
        out["latency"] = [
            capped.plan_rate("count", B(max_latency_s=0.05, floor_rate=0.01),
                             0.4)]
        capped.curve("count").observe(16, 0.5)
        out["latency"].append(capped.plan_rate(
            "count", B(max_rel_error=0.05, max_latency_s=0.05,
                       floor_rate=0.01), 0.4))
        fed = R(16)
        fed.observe_result("count", 0.5, 8, 0.3)
        fed.observe_result("count", 0.0, 1, float("inf"))
        out["fed"] = (fed.curve("count").count, fed._ref_rate)
        return out
    rec = both(run)
    assert rec["degenerate"] == [None, 0]
    assert rec["latency"][0] == pytest.approx(0.2)


def test_degradation_ladder_and_audit():
    def run(m):
        B, R = m.budget.QueryBudget, m.budget.RatePlanner
        planner = R(16)
        qs = [_Q("count", B(max_rel_error=0.5, floor_rate=0.1)), _Q("bool")]
        out = {}
        for p in (0.0, 0.5, 1.0, 7.0, -3.0):
            rates, audit = planner.plan_batch(qs, 0.4, pressure=p)
            out[str(p)] = dict(rates=rates, audit=audit.record())
        tiny = R(4)
        _, audit = tiny.plan_batch(
            [_Q("count", B(max_rel_error=0.5, floor_rate=0.3)), _Q("ranked")],
            0.25, pressure=0.25)
        rec = audit.record()
        json.dumps(rec)
        for xs in (rec["planned_rates"], rec["est_rel_error"]):
            assert all(x is None or math.isfinite(x) for x in xs)
        out["tiny"] = rec
        return out
    rec = both(run)
    assert rec["1.0"]["audit"]["degraded"] == 2
    assert rec["7.0"]["rates"] == rec["1.0"]["rates"]


# ----------------------------------------------------------------------
# controller
# ----------------------------------------------------------------------
def _cfg(m, **kw):
    base = dict(min_delay_s=1e-4, max_delay_s=0.02, min_batch=1,
                max_batch=128)
    base.update(kw)
    return m.controller.ControllerConfig(**base)


def _drive(c, gaps, batches=(), t0=0.0):
    t = t0
    c.observe_arrival(t)
    for g in gaps:
        t += g
        c.observe_arrival(t)
    for n, s in batches:
        c.observe_batch(n, s)
    return t


def _plan_rec(plan):
    return dict(delay_s=plan.delay_s, max_batch=plan.max_batch,
                saturated=plan.saturated, utilization=plan.utilization,
                est_p99_s=plan.est_p99_s)


@pytest.mark.parametrize("trace", ["light", "heavy", "ramp", "bursty",
                                   "saturated", "transition"])
def test_controller_plans_on_synthetic_traces(trace):
    def run(m):
        c = m.controller.WindowController(_cfg(m))
        service = [(n, 5e-4 + 5e-5 * n) for n in (4, 8, 16, 32)] * 2
        plans = []
        if trace == "light":
            t = _drive(c, [0.05] * 300, [(1, 1e-3)] * 20)
        elif trace == "heavy":
            t = _drive(c, [1e-4] * 300, [(n, 5e-4 + 5e-5 * n) for n in
                                         (8, 16, 32, 64, 16, 8, 64, 32)] * 3)
        elif trace == "ramp":
            t = _drive(c, np.geomspace(1e-2, 1e-4, 150), service)
            plans.append(c.plan(t))
            t = _drive(c, np.geomspace(1e-4, 1e-2, 300), service, t0=t)
        elif trace == "bursty":
            t = 0.0
            for _ in range(20):
                t = _drive(c, [2e-4] * 30, t0=t) + 0.2
                c.observe_batch(16, 2e-3)
        elif trace == "saturated":
            t = _drive(c, [1e-5] * 300, [(n, 1e-2 + 1e-3 * n)
                                         for n in (8, 32, 128)] * 3)
        else:
            t = _drive(c, [1 / 1500] * 300)
            for _ in range(40):
                for n in (1, 2):
                    c.observe_batch(n, 2e-4 + 2e-5 * n)
                for n in (16, 32, 64):
                    c.observe_batch(n, 1.5e-3 + 2e-5 * n)
        plans.append(c.plan(t))
        return dict(plans=[_plan_rec(p) for p in plans],
                    rate=c.arrival_rate, model=c.service_model(),
                    costs=[c.service_cost(n) for n in (1, 2, 32)],
                    pressure=c.pressure, retry=c.retry_after_s())
    rec = both(run)
    last = rec["plans"][-1]
    if trace == "light":
        assert last["max_batch"] == 1 and not last["saturated"]
    if trace == "saturated":
        assert last["saturated"] and last["max_batch"] == 128


def test_controller_models_cache_and_validation():
    def run(m):
        C = m.controller
        out = {}
        c = C.WindowController(_cfg(m))
        out["rate0"] = c.arrival_rate
        _drive(c, [0.01] * 200)
        out["rate"] = c.arrival_rate
        for _ in range(40):
            for n in (1, 2, 4, 8, 16, 32):
                c.observe_batch(n, 2e-3 + 1e-4 * n)
        out["line"] = c.service_model()
        flat = C.WindowController(_cfg(m))
        for _ in range(30):
            flat.observe_batch(8, 4e-3)
        out["flat"] = (flat.service_model(), flat.service_cost(2))
        cached = C.WindowController(_cfg(m))
        _drive(cached, [1e-3] * 300)
        out["params"] = cached.window_params(now=1000.0)
        first = cached.current_plan
        cached.window_params(now=1000.0 + cached.config.control_period_s / 2)
        same = cached.current_plan is first
        cached.observe_batch(4, 1e-3)
        cached.window_params(now=1000.0 + cached.config.control_period_s / 2)
        out["cache"] = (same, cached.current_plan is first)
        esc = C.WindowController(_cfg(m))
        out["escalate"] = (esc.retry_after_s(), esc.escalate_pressure(),
                           esc.pressure)
        raised = 0
        for kw in (dict(min_delay_s=0.01, max_delay_s=0.001),
                   dict(min_batch=8, max_batch=4), dict(arrival_alpha=0.0),
                   dict(service_alpha=1.5), dict(degrade_exit_util=0.9),
                   dict(degrade_enter_util=0.5, degrade_exit_util=0.5),
                   dict(degrade_step=0.0), dict(degrade_step=1.5)):
            with pytest.raises(ValueError):
                C.ControllerConfig(**kw)
            raised += 1
        out["raised"] = raised
        return out
    rec = both(run)
    assert rec["cache"] == [True, False]
    assert rec["rate"] == pytest.approx(100.0, rel=0.05)


def test_pressure_ratchet_hysteresis():
    def run(m):
        class Pinned(m.controller.WindowController):
            def __init__(self, rho):
                super().__init__(_cfg(m))
                self.rho = rho

            def _estimate_p99(self, lam, d, n):
                return (1e-3, self.rho)

        c = Pinned(0.9)
        trail = []
        for i, rho in enumerate([0.9] * 7 + [0.7] + [0.3] * 5):
            c.rho = rho
            c.plan(float(i + 1))
            trail.append(c.pressure)
        sat = m.controller.WindowController(_cfg(m))
        t = _drive(sat, [1e-5] * 300, [(1, 1e-2)] * 5)
        sat.plan(t)
        return dict(trail=trail, saturated=sat.pressure)
    rec = both(run)
    assert max(rec["trail"]) == 1.0 and rec["trail"][-1] == 0.0


# ----------------------------------------------------------------------
# window (the frontend; its engine is a stand-in)
# ----------------------------------------------------------------------
class _Recording:
    def __init__(self):
        self.batches, self._lock = [], threading.Lock()

    def execute(self, queries, rate, rng=None):
        with self._lock:
            self.batches.append(list(queries))
        return [("done", q, rate) for q in queries]


class _Gated(_Recording):
    def __init__(self):
        super().__init__()
        self.started, self.release = threading.Event(), threading.Event()

    def execute(self, queries, rate, rng=None):
        self.started.set()
        assert self.release.wait(timeout=10)
        return super().execute(queries, rate, rng)


class _Elastic(_Gated):
    accepts_pressure = True

    def __init__(self):
        super().__init__()
        self.pressures = []

    def execute(self, queries, rate, rng=None, pressure=0.0):
        self.pressures.append(pressure)
        return super().execute(queries, rate, rng)


_STATS = ("batches", "served", "closed_by_size", "closed_by_flush",
          "cancelled", "shed", "escalated", "degraded")


def test_window_size_flush_cancel_and_failures():
    def run(m):
        W = m.window.BatchWindow
        eng = _Recording()
        with W(eng, 0.5, max_batch=4, max_delay_s=30.0) as win:
            res = [f.result(timeout=10)
                   for f in [win.submit(i) for i in range(8)]]
        out = dict(size=(res, [len(b) for b in eng.batches],
                         {k: win.stats[k] for k in _STATS}))
        win = W(_Recording(), 1.0, max_batch=100, max_delay_s=30.0)
        f1 = win.submit("a")
        win.flush()
        f1.result(timeout=10)
        f2 = win.submit("b")
        win.close()
        f2.result(timeout=10)
        with pytest.raises(RuntimeError):
            win.submit("c")
        out["flush"] = {k: win.stats[k] for k in _STATS}
        win = W(_Recording(), 1.0, max_batch=100, max_delay_s=0.05)
        doomed = win.submit("doomed")
        assert doomed.cancel()
        ok = win.submit("ok").result(timeout=10)
        win.close()
        out["cancel"] = (ok, win.stats["cancelled"], win.stats["served"])

        class Boom:
            def execute(self, queries, rate, rng=None):
                raise RuntimeError("engine exploded")

        win = W(Boom(), 1.0, max_batch=2, max_delay_s=0.01)
        errs = []
        for f in (win.submit(1), win.submit(2)):
            with pytest.raises(RuntimeError) as e:
                f.result(timeout=10)
            errs.append(str(e.value))
        win.close()
        out["errors"] = errs
        for kw in (dict(max_batch=0), dict(max_delay_s=-1.0)):
            with pytest.raises(ValueError):
                W(_Recording(), 1.0, **kw)
        return out
    rec = both(run)
    assert rec["size"][1] == [4, 4]
    assert rec["cancel"] == [["done", "ok", 1.0], 1, 1]


def test_window_backpressure_then_degrade_before_shed():
    def run(m):
        W, C = m.window.BatchWindow, m.controller

        class Fixed(C.WindowController):
            def __init__(self):
                super().__init__(_cfg(m))

            def window_params(self, now=None):
                return (10.0, 1)

        eng = _Gated()
        win = W(eng, 1.0, max_batch=1, max_delay_s=1e-4, max_pending=3)
        first = win.submit("busy")
        assert eng.started.wait(timeout=10)
        queued = [win.submit(i) for i in range(3)]
        with pytest.raises(C.Backpressure) as exc:
            win.submit("shed")
        depth = exc.value.depth
        eng.release.set()
        done = [first.result(timeout=10)] + [f.result(timeout=10)
                                             for f in queued]
        win.close()
        out = dict(shed=(depth, [d[1] for d in done],
                         {k: win.stats[k] for k in _STATS}))
        ctrl, el = Fixed(), _Elastic()
        win = W(el, 0.5, max_batch=1, controller=ctrl, max_pending=2)
        futs = [win.submit("busy")]
        assert el.started.wait(timeout=10)
        futs += [win.submit(i) for i in range(2)]
        futs += [win.submit("deg1"), win.submit("deg2")]
        with pytest.raises(C.Backpressure):
            win.submit("shed")
        el.release.set()
        for f in futs:
            f.result(timeout=10)
        win.close()
        out["degrade"] = (ctrl.pressure, el.pressures,
                          {k: win.stats[k] for k in _STATS})
        return out
    rec = both(run)
    assert rec["degrade"][1][0] == 0.0 and set(rec["degrade"][1][1:]) == {1.0}
    assert rec["degrade"][2]["escalated"] == 2


def test_window_serves_the_engine_at_census(worlds):
    def run(m):
        corpus, index = worlds[m.name]
        with m.executor.ShardTaskExecutor(workers=2) as ex:
            eng = m.queries.QueryBatch(corpus, index, executor=ex)
            with m.window.BatchWindow(eng, 1.0, max_batch=3,
                                      max_delay_s=0.02) as win:
                res = [f.result(timeout=60) for f in
                       [win.submit(q) for q in mixed_queries(m)]]
            assert ex.stats["pool_rebuilds"] == 1
        return result_record(res)
    rec = both(run)
    assert rec[0]["value"] == float(worlds["port"][0].count_phrase([3]))


# ----------------------------------------------------------------------
# fleet
# ----------------------------------------------------------------------
def _ids(corpus, hg):
    return sorted(hg.map_shards(corpus, range(len(corpus.shards)),
                                lambda s: s.shard_id))


def _event(ev):
    return {k: v for k, v in ev.items() if not k.endswith("_s")}


@pytest.mark.parametrize("op", ["drain", "crash", "join", "revive",
                                "lifecycle"])
def test_fleet_membership(op):
    def run(m):
        P, F = m.placement.PlacementMap, m.fleet.FleetManager
        reps, n, hosts = (0, 8, 2) if op == "revive" else (1, 12, 3)
        if op in ("join", "lifecycle"):
            hosts = 2
        with m.placement.HostGroupExecutor(
                P.blocked(n, hosts, n_replicas=reps), workers_per_host=1,
                allow_partial=op == "revive") as hg:
            streamed = []

            def warm(sid, src, dst):
                assert not (hg.placement.primary == dst).any()
                streamed.append((sid, src, dst))

            fleet = F(hg, warm_fn=warm)
            out = {}
            if op == "drain":
                out["ev"] = _event(fleet.drain(1))
            elif op == "crash":
                out["ev"] = _event(fleet.crash(2))
            elif op == "join":
                out["ev"] = _event(fleet.join())
            elif op == "revive":
                out["crash"] = _event(fleet.crash(1))
                out["partial"] = _ids(FakeCorpus(n), hg)
                out["lost"] = hg.stats["lost_shards"]
                out["ev"] = _event(fleet.join())
            else:
                fleet.crash(1)
                fleet.join(2)
                fleet.drain(0)
            if op != "lifecycle":      # one live host: not every shard
                out["ids"] = _ids(FakeCorpus(n), hg)
            out.update(down=sorted(hg.down),
                       primary=hg.placement.primary, streamed=streamed,
                       epoch=hg.stats["placement_epoch"],
                       live=fleet.live_hosts())
            rec = fleet.record()
            json.dumps(rec)
            out["record"] = dict(
                {k: v for k, v in rec.items() if k != "events"},
                events=[_event(e) for e in rec["events"]])
            return out
    rec = both(run)
    if op != "lifecycle":
        assert rec["ids"] == list(range(len(rec["ids"])))
    else:
        assert rec["epoch"] == 3 and rec["live"] == [2]


def test_all_replicas_dead_degrades_or_raises(worlds, rows):
    def run(m):
        corpus, index = worlds[m.name]
        qs = mixed_queries(m)[:3]
        pm = m.placement.PlacementMap.blocked(corpus.n_shards, 2,
                                              n_replicas=0)
        with m.placement.HostGroupExecutor(pm, workers_per_host=1) as hg:
            m.fleet.FleetManager(hg).crash(1)
            eng = m.queries.QueryBatch(corpus, index, executor=hg)
            with pytest.raises(m.placement.HostFailure):
                eng.execute(qs, 0.9, rng=np.random.default_rng(0))
        with m.placement.HostGroupExecutor(pm, workers_per_host=1,
                                           allow_partial=True) as hg:
            eng = inject_rows(m.queries.QueryBatch(corpus, index,
                                                   executor=hg), rows[:3])
            m.fleet.FleetManager(hg).crash(1)
            got = eng.execute(qs, 0.9, rng=np.random.default_rng(1))
            deg = eng.last_degraded
        return dict(results=result_record(got), lost=deg["lost_shards"],
                    degraded=deg["degraded_queries"])
    rec = both(run)
    assert rec["lost"] > 0 and rec["results"][0]["lost"] > 0


# ----------------------------------------------------------------------
# chaos
# ----------------------------------------------------------------------
def test_fault_plan_decisions_are_the_same_in_both_packages():
    def run(m):
        out = {}
        plan = m.chaos.FaultPlan(seed=3).flaky(0, error_rate=0.25)
        with m.executor.ShardTaskExecutor(workers=4, max_retries=6) as ex:
            plan.install(ex)
            got = ex.map_shards(FakeCorpus(24), range(24),
                                lambda s: s.shard_id * 2)
        out["flaky"] = (sorted(got.items()), plan.fired["flaky"],
                        ex.stats["retries"])
        for seed in (5, 6):
            p = m.chaos.FaultPlan(seed=seed).flaky(0, error_rate=0.5)
            hook = p._task_hook_for(0)
            p._advance(0)
            dec = []
            for sid in range(40):
                try:
                    hook(sid, 0, 0)
                    dec.append(False)
                except m.chaos.ChaosFault:
                    dec.append(True)
            out[f"seed{seed}"] = dec
        p = m.chaos.FaultPlan(seed=0).crash(1, at_job=2).stall(0, s=0.01,
                                                               jobs=[1])
        p._advance(1)
        p._host_hook(0, [1, 2])
        p._host_hook(1, [3])
        crashes = 0
        for job in (2, 7):
            p._advance(job)
            with pytest.raises(m.chaos.ChaosCrash):
                p._host_hook(1, [3])
            crashes += 1
        out["record"] = p.record()
        return out
    rec = both(run)
    assert rec["flaky"][1] == rec["flaky"][2] > 0
    assert rec["seed5"] != rec["seed6"]
    assert rec["record"]["fired"]["crash"] == 2


def test_executor_deadline_partial_and_zombie_guard():
    def run(m):
        out = {}

        def slow_tail(sid, attempt, job):
            if sid >= 4:
                time.sleep(0.5)

        with m.executor.ShardTaskExecutor(workers=2, task_hook=slow_tail,
                                          job_deadline_s=0.15,
                                          allow_partial=True) as ex:
            got = ex.map_shards(FakeCorpus(6), range(6), lambda s: s.shard_id)
            out["partial"] = (sorted(got), ex.stats["lost_shards"])

        def flake_once(sid, attempt, job, seen=set()):
            if attempt == 1 and sid == 2 and 2 not in seen:
                seen.add(2)
                raise m.chaos.ChaosFault("one transient fault")

        with m.executor.ShardTaskExecutor(workers=2, task_hook=flake_once,
                                          retry_backoff_s=0.02) as ex:
            got = ex.map_shards(FakeCorpus(4), range(4), lambda s: s.shard_id)
            out["retry"] = (sorted(got.items()), ex.stats["retries"])
        return out
    rec = both(run)
    assert rec["partial"] == [[0, 1, 2, 3], 2]


@pytest.mark.parametrize("scenario", ["crash_then_join", "drain_mid_stream",
                                      "flaky_everywhere", "stall_and_slow"])
def test_chaos_scenarios_keep_parity_and_lose_nothing(worlds, rows,
                                                      scenario):
    def run(m):
        corpus, index = worlds[m.name]
        qs = mixed_queries(m)[:4]
        pm = m.placement.PlacementMap.blocked(corpus.n_shards, 2,
                                              n_replicas=1)
        answers = []
        with m.executor.ShardTaskExecutor(workers=2) as single, \
                m.placement.HostGroupExecutor(pm, workers_per_host=1,
                                              max_retries=6,
                                              allow_partial=True) as hg:
            ref = inject_rows(m.queries.QueryBatch(corpus, index,
                                                   executor=single), rows[:4])
            eng = inject_rows(m.queries.QueryBatch(corpus, index,
                                                   executor=hg), rows[:4])
            plan, fleet = m.chaos.FaultPlan(seed=1), m.fleet.FleetManager(hg)
            ops = {}
            if scenario == "crash_then_join":
                plan.crash(1, at_job=1)
                ops = {1: lambda: fleet.crash(1), 2: lambda: fleet.join(2)}
            elif scenario == "drain_mid_stream":
                ops = {1: lambda: fleet.drain(0)}
            elif scenario == "flaky_everywhere":
                plan.flaky(0, error_rate=0.2).flaky(1, error_rate=0.2)
            else:
                plan.stall(0, s=0.02, jobs=[1]).slow(1, ms_per_shard=1.0)
            plan.install(hg)
            for batch in range(4):
                got = eng.execute(qs, 0.5,
                                  rng=np.random.default_rng(100 + batch))
                want = ref.execute(qs, 0.5,
                                   rng=np.random.default_rng(100 + batch))
                assert result_record(got) == result_record(want)
                assert eng.last_degraded is None
                answers.append(result_record(got))
                if batch in ops:
                    ops[batch]()
            assert hg.stats["lost_shards"] == 0
        return answers
    both(run)
