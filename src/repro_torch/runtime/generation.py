"""The one typed version authority for the serving stack.

A cache entry is valid only under both the placement it was routed
under and the corpus content it was computed over: an append changes
*content* without changing *placement*, and a fleet swap changes
placement without changing content.  This module owns the mint.
Nothing else in the tree increments a generation int; every layer
reads and fences on the same handle.

``Generation`` is a frozen value with two independent axes:

  * ``placement`` — which placement map queries route under.  Bumped by
    ``HostGroupExecutor.set_placement`` (fleet join / drain / crash,
    balancer splits, open-shard residency extension).
  * ``content`` — which corpus + index artifacts queries read.  Bumped
    by the ingest swap and by ``ApproxIndex.attach_corpus``.

Equality compares both axes, so fencing code written against the old
int epochs (``entry.epoch != epoch`` → drop) keeps working verbatim
once handed ``Generation`` values.  ``GenerationClock`` is the
thread-safe mint: readers call ``current()``; the two writers call
``bump_placement()`` / ``bump_content()``.  ``build_serving_stack``
creates one clock and binds every layer (executor, index, cache
epochs, ingestor) to it; standalone constructions get a private clock
so the API works un-wired too.

Deprecated read-only views (kept for pre-generation callers, pinned by
tests): ``stats["placement_epoch"]`` mirrors ``current().placement``
after every bump, and the cache still accepts raw ints as epochs.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Generation:
    """An immutable (placement, content) version pair.

    Hashable and JSON-clean (via :meth:`record`), so it can key caches
    and ride inside bench/audit records.  Ordering is deliberately not
    defined: the two axes advance independently, so "newer" is only
    meaningful per axis.
    """

    placement: int = 0
    content: int = 0

    def record(self) -> Dict[str, int]:
        """JSON-clean dict form for audits and bench records."""
        return dict(placement=int(self.placement), content=int(self.content))


class GenerationClock:
    """Thread-safe single mint for :class:`Generation` values.

    One instance per serving stack (shared by executor, index, cache
    and ingestor); components built standalone default to a private
    clock so nothing needs wiring to merely work.
    """

    def __init__(self, start: Generation | None = None) -> None:
        self._gen = start if start is not None else Generation()
        self._lock = threading.Lock()

    def current(self) -> Generation:
        """The generation new work should capture (RCU read side)."""
        with self._lock:
            return self._gen

    def bump_placement(self) -> Generation:
        """Mint the next placement generation; returns the new value."""
        with self._lock:
            self._gen = Generation(self._gen.placement + 1, self._gen.content)
            return self._gen

    def bump_content(self) -> Generation:
        """Mint the next content generation; returns the new value."""
        with self._lock:
            self._gen = Generation(self._gen.placement, self._gen.content + 1)
            return self._gen
