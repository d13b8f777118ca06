"""The query-side serving runtime, bottom-up (the JAX package's
``runtime/``, module for module):

  ``executor``   — single-host fault-tolerant shard tasks (warm pool,
                   retry, straggler speculation, shared scans, the
                   one-launch megascan route)
  ``placement``  — shard -> host residency (``PlacementMap``) and the
                   multi-host executor (``HostGroupExecutor``):
                   per-host shared scans, cross-host gather, replica
                   failover
  ``balance``    — replica-aware load balancing (``HostLoadModel`` +
                   ``plan_split``): per-host EWMA cost model over
                   realized host-group wall times, greedy LPT shedding
                   from hot hosts onto live replicas, hysteresis
  ``window``     — the batching frontend (``BatchWindow``): stream of
                   queries in, deadline/size-closed batches out
  ``controller`` — queueing-theory window autotuner
                   (``WindowController``) + ``Backpressure`` shedding
                   + the degradation-pressure state machine
  ``budget``     — error/latency budgets (``QueryBudget``) and the
                   SLO-driven rate planner (``RatePlanner``)
  ``fleet``      — elastic membership (``FleetManager``): host
                   join/drain/crash as audited generation swaps
  ``qcache``     — the semantic query cache (``SemanticQueryCache``)
  ``generation`` — the single generation authority (``Generation`` +
                   ``GenerationClock``): every placement swap and every
                   content swap in a stack mints through one clock
  ``chaos``      — deterministic fault injection (``FaultPlan``): a
                   seeded, scripted scenario compiled onto the
                   executors' injection seams

The multi-host dataflow is placement -> balance -> executor: the
``PlacementMap`` bounds where a shard *may* run (primary + live ring
replicas), the balancer picks where it *should*, and the per-host
``ShardTaskExecutor`` fleet runs the groups, feeding realized per-host
wall times back into the balancer's cost model.  The gather above is
split-agnostic, so every flavor of split produces bit for bit the
single-executor results.  With ``MegascanSpec`` scan fns
(``kernels/megascan``) each host's group runs as ONE kernel launch on
that host's executor: on CUDA one launch of the megascan segment sum a
host group, on the CPU its plain version.

Everything here is numpy and threads; no kernel runs in this package.
On one card the simulated hosts' coordinators all launch on the card's
current stream.  Live ingest (``launch.serve_stack.Ingestor``) rides
the same RCU discipline on the content axis: the new corpus and index
refs publish first, then the clock mints ``bump_content()``, and the
next cache probe under the new generation drops every entry stamped
with the old one.
"""
from repro_torch.runtime.balance import (  # noqa: F401
    BalanceConfig,
    HostLoadModel,
    plan_split,
)
from repro_torch.runtime.budget import (  # noqa: F401
    BudgetAudit,
    PlannerConfig,
    QueryBudget,
    RatePlanner,
)
from repro_torch.runtime.controller import (  # noqa: F401
    Backpressure,
    ControllerConfig,
    WindowController,
    WindowPlan,
)
from repro_torch.runtime.chaos import FaultPlan  # noqa: F401
from repro_torch.runtime.executor import ShardTaskExecutor  # noqa: F401
from repro_torch.runtime.fleet import FleetManager  # noqa: F401
from repro_torch.runtime.generation import (  # noqa: F401
    Generation,
    GenerationClock,
)
from repro_torch.runtime.placement import (  # noqa: F401
    HostFailure,
    HostGroupExecutor,
    PlacementMap,
)
from repro_torch.runtime.qcache import (  # noqa: F401
    QueryCacheConfig,
    SemanticQueryCache,
)
from repro_torch.runtime.window import BatchWindow  # noqa: F401
