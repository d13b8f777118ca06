"""One-call construction of the serving stack (``build_serving_stack``),
the JAX package's ``launch/serve_stack.py`` over the port's layers.

``ServeConfig`` names every knob once and ``build_serving_stack`` wires
the layers in the one correct order:

    corpus + index
        -> clock           (GenerationClock — the stack's single
                            generation authority, shared by the
                            executor's placement axis and the index's
                            content axis)
        -> executor        (single-host pool, or PlacementMap +
                            HostGroupExecutor when ``hosts >= 2``,
                            balanced / replicated / partial-tolerant)
        -> cache           (SemanticQueryCache, optional)
        -> planner         (RatePlanner against the controller's cost
                            model, optional)
        -> engine          (QueryBatch carrying all of the above)
        -> controller      (WindowController, optional)
        -> window          (BatchWindow frontend, optional)
        -> fleet           (FleetManager over the host group, optional)
        -> ingestor        (Ingestor — live append path, optional)

The returned ``ServingStack`` exposes each layer by name, closes
bottom-up, and works as a context manager.  The facade is additive:
``QueryBatch(...)`` and friends keep their constructors — this is the
single *convenient* construction path, not the only one.

    from repro_torch.launch.serve_stack import ServeConfig, build_serving_stack

    with build_serving_stack(corpus, index, hosts=2, cache=True,
                             planner=True) as stack:
        fut = stack.window.submit(query)          # streaming front
        results = stack.engine.execute(qs, 0.25)  # or batch-at-a-time
        print(stack.cache.record())

Live ingest (``ingest=True`` + the trained model) appends documents
to a *serving* stack with zero pause: ``stack.ingestor.step(docs)``
builds the appended corpus/index off to the side (postings delta
merge + frozen-model PV-DBOW inference + incremental centroid
refresh), publishes the new refs RCU-style, then bumps the content
generation so cached answers over the old corpus fence themselves.
Inference runs on the model's device (the card unless the caller
trained on the CPU), one document after another; the new index's
device caches are built on its first plan.
In-flight batches keep the refs they captured at entry — no reader
ever blocks on the writer.  Give ``ingest_source`` a callable and the
stack polls it from a background thread; ``close()`` stops the writer
first, then drains the window, then the pools.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, List, Optional

import numpy as np

from repro_torch.core.index import refresh_appended
from repro_torch.core.queries.batch import QueryBatch
from repro_torch.runtime.budget import PlannerConfig, RatePlanner
from repro_torch.runtime.controller import ControllerConfig, WindowController
from repro_torch.runtime.executor import ShardTaskExecutor
from repro_torch.runtime.fleet import FleetManager
from repro_torch.runtime.generation import Generation, GenerationClock
from repro_torch.runtime.placement import HostGroupExecutor, PlacementMap
from repro_torch.runtime.qcache import QueryCacheConfig, SemanticQueryCache
from repro_torch.runtime.window import BatchWindow


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every serving-stack knob, named once.

    Groups (all optional beyond the defaults):

    * engine — ``rate`` (nominal sampling rate the window serves at),
      ``method``, ``confidence``, ``ci``.
    * topology — ``hosts`` (>= 2 builds a blocked ``PlacementMap`` +
      ``HostGroupExecutor``; otherwise a single ``ShardTaskExecutor``),
      ``replicas``, ``balanced``, ``workers`` (total across hosts),
      ``allow_partial``, ``fault_hook`` (per-shard-task),
      ``host_fault_hook`` (per-host, host groups only),
      ``adaptive_workers``, ``max_retries``.
    * budget — ``planner`` attaches a ``RatePlanner``
      (``planner_config``) so queries may carry ``QueryBudget``s and
      the engine degrades under pressure.
    * cache — ``cache`` attaches a ``SemanticQueryCache``
      (``cache_config``) keyed on the index's LSH signatures.
    * window — ``window`` builds the ``BatchWindow`` frontend
      (``max_batch``, ``max_delay_s``, ``max_pending``); ``adaptive``
      adds the ``WindowController`` (``controller_config``).
    * fleet — ``fleet`` wraps a host group in a ``FleetManager``
      (``warm_fn``) for join/drain/crash.
    * ingest — ``ingest`` attaches an ``Ingestor`` (requires the
      trained ``ingest_model`` + its ``ingest_pv_cfg`` for
      frozen-model inference over appended docs).  ``ingest_source``
      (a ``source(max_docs) -> list-of-token-arrays`` callable, or
      None for manual ``step()`` driving) is polled ``refresh_docs``
      docs at a time every ``refresh_interval_s`` seconds from a
      background thread; ``ingest_infer_steps`` are the per-doc
      inference steps, ``ingest_shard_tokens`` the shard-spill budget
      for appended docs (None grows the open shard unboundedly, so
      placement never changes).  ``ingest_yield_s`` paces the writer:
      a cooperative GIL yield between inference steps (result-neutral)
      that bounds how long any concurrent serving batch can stall
      behind the append path — raise it to favor serving latency,
      zero it to favor ingest throughput.
    """
    # engine
    rate: float = 0.25
    method: str = "emapprox"
    confidence: float = 0.95
    ci: bool = False
    # topology
    hosts: int = 0
    replicas: int = 1
    balanced: bool = False
    workers: int = 2
    allow_partial: bool = False
    fault_hook: Optional[Callable[[int, int], None]] = None
    host_fault_hook: Optional[Callable[[int, Any], None]] = None
    adaptive_workers: bool = False
    max_retries: int = 2
    # budget
    planner: bool = False
    planner_config: Optional[PlannerConfig] = None
    # cache
    cache: bool = False
    cache_config: Optional[QueryCacheConfig] = None
    # window
    window: bool = False
    adaptive: bool = True
    max_batch: int = 32
    max_delay_s: float = 0.002
    max_pending: Optional[int] = None
    controller_config: Optional[ControllerConfig] = None
    seed: int = 0
    # fleet
    fleet: bool = False
    warm_fn: Optional[Callable[[int, int, int], None]] = None
    # ingest
    ingest: bool = False
    ingest_model: Any = None
    ingest_pv_cfg: Any = None
    ingest_source: Optional[Callable[[int], Any]] = None
    refresh_docs: int = 64
    refresh_interval_s: float = 0.25
    ingest_infer_steps: int = 50
    ingest_shard_tokens: Optional[int] = None
    ingest_yield_s: float = 0.002

    def __post_init__(self):
        if self.hosts < 0:
            raise ValueError(f"hosts must be >= 0, got {self.hosts}")
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.hosts < 2:
            for flag in ("balanced", "fleet"):
                if getattr(self, flag):
                    raise ValueError(
                        f"{flag}=True needs a host group (hosts >= 2), "
                        f"got hosts={self.hosts}")
            if self.host_fault_hook is not None:
                raise ValueError("host_fault_hook needs a host group "
                                 "(hosts >= 2)")
        if self.hosts >= 2 and self.replicas < 0:
            raise ValueError(f"replicas must be >= 0, got {self.replicas}")
        if self.ingest:
            if self.ingest_model is None or self.ingest_pv_cfg is None:
                raise ValueError(
                    "ingest=True requires ingest_model and ingest_pv_cfg "
                    "(the index refresh runs frozen-model PV-DBOW "
                    "inference over appended docs)")
            if self.refresh_docs < 1:
                raise ValueError(
                    f"refresh_docs must be >= 1, got {self.refresh_docs}")
            if self.refresh_interval_s <= 0:
                raise ValueError(f"refresh_interval_s must be > 0, "
                                 f"got {self.refresh_interval_s}")
            if self.ingest_infer_steps < 1:
                raise ValueError(f"ingest_infer_steps must be >= 1, "
                                 f"got {self.ingest_infer_steps}")
            if (self.ingest_shard_tokens is not None
                    and self.ingest_shard_tokens < 1):
                raise ValueError(f"ingest_shard_tokens must be >= 1 or "
                                 f"None, got {self.ingest_shard_tokens}")
            if self.ingest_yield_s < 0:
                raise ValueError(f"ingest_yield_s must be >= 0, "
                                 f"got {self.ingest_yield_s}")
        else:
            for name in ("ingest_model", "ingest_pv_cfg", "ingest_source"):
                if getattr(self, name) is not None:
                    raise ValueError(
                        f"{name} is set but ingest=False — pass "
                        f"ingest=True to attach the live append path")


class Ingestor:
    """The live append path: documents in, a new generation out, with
    zero serving pause.

    ``step(docs)`` runs the whole ingest pipeline synchronously under
    the writer lock (there is exactly one writer; readers never take
    it):

      1. **append** — ``corpus.append_documents`` builds the grown
         corpus copy-on-write: untouched shards are shared by
         reference, postings deltas merge into any already-built CSR
         bit-for-bit with a from-scratch rebuild.
      2. **refresh** — ``core.index.refresh_appended`` infers vectors
         for the new docs with the *frozen* model (paced by
         ``yield_s`` so serving threads never stall behind more than
         one inference dispatch), re-signs and re-centroids only the
         touched shards, and returns a fresh index sharing the
         stack's ``GenerationClock``.
      3. **placement** — if the append spilled new shards, the host
         group's placement extends in place (old shards keep their
         hosts; the placement generation bumps).
      4. **publish** — the engine's/stack's corpus+index refs swap
         (RCU: in-flight batches keep the refs they captured at
         entry), and only *then* does the content generation bump, so
         a racing reader can at worst stamp a fresh answer with the
         old generation — it can never serve a stale answer under the
         new one.

    ``start()`` drives ``step`` from a background thread polling
    ``source``; ``close()`` is idempotent and joins the thread.
    ``swapped`` is an event that every publishing ``step`` sets, so a
    caller can wait for the writer without polling its counters."""

    def __init__(self, stack: "ServingStack", model, pv_cfg, *,
                 source: Optional[Callable[[int], Any]] = None,
                 refresh_docs: int = 64, refresh_interval_s: float = 0.25,
                 infer_steps: int = 50,
                 shard_tokens: Optional[int] = None,
                 yield_s: float = 0.002):
        self._stack = stack
        self._model = model
        self._pv_cfg = pv_cfg
        self._source = source
        self._refresh_docs = int(refresh_docs)
        self._refresh_interval_s = float(refresh_interval_s)
        self._infer_steps = int(infer_steps)
        self._shard_tokens = shard_tokens
        self._yield_s = float(yield_s)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.swapped = threading.Event()
        self.errors: List[str] = []
        self.stats = dict(steps=0, docs_appended=0, swaps=0,
                          shards_added=0)

    # ------------------------------------------------------------------
    def step(self, docs_tokens) -> dict:
        """Append ``docs_tokens`` (a list of token arrays) and publish
        the new generation; returns a record of what changed.  Safe to
        call concurrently with serving; serialized against itself."""
        with self._lock:
            stack = self._stack
            engine = stack.engine
            corpus, index = engine.corpus, engine.index
            new_corpus, new_ids, affected = corpus.append_documents(
                docs_tokens, shard_tokens=self._shard_tokens)
            self.stats["steps"] += 1
            if len(new_ids) == 0:
                return dict(appended=0, new_shards=0,
                            generation=stack.clock.current().record())
            new_index = refresh_appended(
                index, new_corpus, self._model, self._pv_cfg,
                docs_tokens, affected, infer_steps=self._infer_steps,
                infer_pause_s=self._yield_s)
            grown = new_corpus.n_shards - corpus.n_shards
            if grown and hasattr(stack.executor, "set_placement"):
                stack.executor.set_placement(
                    stack.executor.placement.extend(new_corpus.n_shards))
            # RCU publish: refs first (one atomic store — a racing
            # batch can never capture a torn pair), generation second
            # (see class docstring for why this order is the safe one)
            engine.swap_world(new_corpus, new_index)
            stack.corpus, stack.index = new_corpus, new_index
            gen = stack.clock.bump_content()
            self.stats["docs_appended"] += int(len(new_ids))
            self.stats["swaps"] += 1
            self.stats["shards_added"] += int(grown)
            self.swapped.set()
            return dict(appended=int(len(new_ids)), new_shards=int(grown),
                        generation=gen.record())

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Start the background polling thread (needs ``source``)."""
        if self._source is None:
            raise ValueError("Ingestor.start() needs an ingest_source")
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="ingestor", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                docs = self._source(self._refresh_docs)
                if docs:
                    self.step(list(docs))
            except Exception as e:  # noqa: BLE001 - surfaced in record()
                self.errors.append(f"{type(e).__name__}: {e}")
                break
            self._stop.wait(self._refresh_interval_s)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def close(self) -> None:
        """Idempotent: stop and join the polling thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def record(self) -> dict:
        """JSON-ready ingest counters + the stack's generation."""
        return dict(
            running=self.running,
            refresh_docs=self._refresh_docs,
            refresh_interval_s=self._refresh_interval_s,
            generation=self._stack.clock.current().record(),
            errors=list(self.errors),
            **{k: int(v) for k, v in self.stats.items()})


@dataclasses.dataclass
class ServingStack:
    """The wired layers, by name.  ``window``/``controller``/
    ``planner``/``cache``/``fleet``/``ingestor`` are None when not
    configured; ``executor``, ``engine`` and ``clock`` always exist.

    ``clock`` is the stack's single generation authority: the
    executor's placement swaps and the ingestor's content swaps both
    mint through it, and ``generation`` is the current composite."""
    config: ServeConfig
    corpus: Any
    index: Any
    executor: Any
    engine: QueryBatch
    clock: GenerationClock = dataclasses.field(
        default_factory=GenerationClock)
    controller: Optional[WindowController] = None
    planner: Optional[RatePlanner] = None
    cache: Optional[SemanticQueryCache] = None
    window: Optional[BatchWindow] = None
    fleet: Optional[FleetManager] = None
    ingestor: Optional[Ingestor] = None

    @property
    def generation(self) -> Generation:
        """The stack's current (placement, content) generation."""
        return self.clock.current()

    def close(self) -> None:
        """Idempotent bottom-up shutdown: stop the ingest writer, then
        drain the window, then stop the executor pool(s)."""
        if self.ingestor is not None:
            self.ingestor.close()
        if self.window is not None:
            self.window.close()
        self.executor.close()

    def __enter__(self) -> "ServingStack":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_serving_stack(corpus, index, config: Optional[ServeConfig] = None,
                        **overrides) -> ServingStack:
    """Wire the full serving stack from one config.

    ``config`` may be a ready ``ServeConfig``; keyword overrides are
    applied on top (``build_serving_stack(c, i, hosts=2, cache=True)``
    is the short form).  See ``ServeConfig`` for the knobs."""
    cfg = config or ServeConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    # one generation authority per stack: the executor's placement
    # axis and the index's content axis mint through the same clock
    clock = GenerationClock()
    if index is not None:
        index.use_clock(clock)

    if cfg.hosts >= 2:
        placement = PlacementMap.blocked(corpus.n_shards, cfg.hosts,
                                         n_replicas=cfg.replicas)
        executor = HostGroupExecutor(
            placement,
            workers_per_host=max(1, cfg.workers // cfg.hosts),
            balanced=cfg.balanced,
            allow_partial=cfg.allow_partial,
            host_fault_hook=cfg.host_fault_hook,
            fault_hook=cfg.fault_hook,
            adaptive_workers=cfg.adaptive_workers,
            max_retries=cfg.max_retries,
            clock=clock)
    else:
        executor = ShardTaskExecutor(
            workers=cfg.workers,
            fault_hook=cfg.fault_hook,
            adaptive_workers=cfg.adaptive_workers,
            allow_partial=cfg.allow_partial,
            max_retries=cfg.max_retries)

    controller = None
    if cfg.window and cfg.adaptive:
        controller = WindowController(cfg.controller_config
                                      or ControllerConfig())

    planner = None
    if cfg.planner:
        planner = RatePlanner(corpus.n_shards, controller=controller,
                              config=cfg.planner_config)

    cache = None
    if cfg.cache:
        cache = SemanticQueryCache(cfg.cache_config)

    engine = QueryBatch(corpus, index, executor=executor,
                        method=cfg.method, confidence=cfg.confidence,
                        planner=planner, ci=cfg.ci, cache=cache)

    window = None
    if cfg.window:
        window = BatchWindow(engine, cfg.rate,
                             max_batch=cfg.max_batch,
                             max_delay_s=cfg.max_delay_s,
                             controller=controller,
                             max_pending=cfg.max_pending,
                             rng=np.random.default_rng(cfg.seed))

    fleet = None
    if cfg.fleet:
        fleet = FleetManager(executor, warm_fn=cfg.warm_fn)

    stack = ServingStack(config=cfg, corpus=corpus, index=index,
                         executor=executor, engine=engine, clock=clock,
                         controller=controller, planner=planner,
                         cache=cache, window=window, fleet=fleet)

    if cfg.ingest:
        stack.ingestor = Ingestor(
            stack, cfg.ingest_model, cfg.ingest_pv_cfg,
            source=cfg.ingest_source,
            refresh_docs=cfg.refresh_docs,
            refresh_interval_s=cfg.refresh_interval_s,
            infer_steps=cfg.ingest_infer_steps,
            shard_tokens=cfg.ingest_shard_tokens,
            yield_s=cfg.ingest_yield_s)
        if cfg.ingest_source is not None:
            stack.ingestor.start()

    return stack
