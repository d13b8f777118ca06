"""Payload builder, wrappers and executor spec for the megascan.

The megascan's input contract is the **block-aligned packed payload**
(``build_payload``), the JAX package's: every shard's shard-sorted
signature rows are padded *independently* to TM-row block boundaries
and concatenated, so each TM block belongs to exactly one shard slot;
padding rows are zero signatures with the out-of-range slot
``slot_pad`` and doc id -1.  The port adds, on the device, each slot's
real-row range (``row_start``, ``row_count``), so the CUDA sum kernel
walks only real rows: at serving scale (shards of ~26 docs, TM = 256)
padding is ~90 % of the payload.

Parity, bit for bit, as in the reference, in both modes (asym: real
query vectors and the hyperplanes; hamming, the paper's sym mode:
packed query signatures):

  * group == per-shard: a slot's sum, and its ranked candidates, depend
    only on its own rows in a fixed order, so the group payload's
    output for slot s equals a single-shard payload's output for shard
    s (``MegascanSpec.run_shard`` is that per-shard route: one launch
    per shard, the same kernels);
  * streamed == pipelined: ``double_buffer=False`` runs the segment sum
    of the mode (``kernels/asym``, ``kernels/hamming``) over the
    payload's slot map, ``double_buffer=True`` the megascan kernel over
    the slot ranges; both reduce each slot's rows with the same
    per-slot sum.

On the CPU the plain versions (``ref.py``) keep both properties.

``MegascanSpec`` is the executor-facing handle: ``scan_fns()`` returns
per-query scan fns whose composite ``run_shared_scan`` closure carries
the spec, so ``ShardTaskExecutor.map_shard_batch`` can route a whole shard
group as ONE launch (``run_group``) while emitting per-(query, shard)
results in exactly the layout the shared-scan gather consumes.  In sym
mode the spec signs its query vectors as the index does, on the host,
so their bits do not depend on the device.

Not ported: the TPU-only arguments ``tb``, ``pad_lanes`` and
``interpret``.  Rows 9 and 10 of the TPU kernel table (the ranked
megascan's two schedules) compute one function and share one CUDA
kernel, so ``megascan_topk`` takes no ``double_buffer``; the ranked
megascan is asym only, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lsh as lsh_mod
from repro_torch.data.store import plan_blocked_layout
from repro_torch.kernels import common
from repro_torch.kernels.asym import ops as asym_ops
from repro_torch.kernels.hamming import ops as hamming_ops
from repro_torch.kernels.megascan import kernel as _km
from repro_torch.kernels.megascan import ref as _mref

_INT32_MAX = 2 ** 31 - 1


def _lane_pad(n: int) -> int:
    return max(128, -(-int(n) // 128) * 128)


@dataclasses.dataclass(frozen=True)
class MegascanPayload:
    """Block-aligned packed multi-shard signature payload.

    ``sig`` rows are grouped per shard slot, each slot padded to a TM
    multiple (padding rows are zero signatures with slot ``slot_pad``,
    an out-of-range slot that reduces into nothing); ``slots`` maps
    every row to its shard slot; ``doc_idx`` maps every row back to the
    global doc id (-1 for padding); ``block_slot[j]`` names the single
    slot TM-block ``j`` belongs to; slot s's real rows are
    ``[row_start[s], row_start[s] + row_count[s])``."""

    sig: torch.Tensor        # [n_rows, W] int32 (uint32 bits), on the device
    slots: torch.Tensor      # [1, n_rows] int32, on the device
    doc_idx: np.ndarray      # [n_rows] int64, -1 on padding rows
    counts: np.ndarray       # [n_slots] int64 real rows per slot
    block_slot: np.ndarray   # [n_blocks] int32 block -> slot
    shard_ids: Tuple[int, ...]
    tm: int
    n_slots: int
    n_blocks: int
    n_rows: int
    row_start: torch.Tensor  # [n_slots] int32, on the device
    row_count: torch.Tensor  # [n_slots] int32, on the device

    @property
    def slot_pad(self) -> int:
        """Lane-padded slot-axis width (the padding rows' slot)."""
        return _lane_pad(self.n_slots)

    @property
    def real_rows(self) -> int:
        return int(self.counts.sum())

    @property
    def nbytes_streamed(self) -> int:
        """Device-memory bytes the sum kernel reads per launch: the real
        rows' signatures and the per-slot row ranges (padding rows are
        never read)."""
        return int(self.real_rows * self.sig.shape[1] * 4
                   + 8 * self.n_slots)


def build_payload(segments: Sequence[Tuple[np.ndarray, np.ndarray]],
                  *, tm: int = 256,
                  shard_ids: Optional[Sequence[int]] = None,
                  device: Any = "cuda") -> MegascanPayload:
    """Pack per-shard ``(signatures [c_i, W] uint32, doc_ids [c_i])``
    segments into one block-aligned payload on ``device``.  Empty
    shards get zero blocks (their slot never appears in
    ``block_slot``)."""
    if not segments:
        raise ValueError("megascan payload needs at least one shard")
    if tm <= 0 or tm & (tm - 1) != 0:
        raise ValueError(f"tm must be a positive power of two, got {tm}")
    dev = common.resolve_device(device)
    w = int(segments[0][0].shape[1])
    counts = np.array([len(s[0]) for s in segments], np.int64)
    row_starts, blocks, n_rows = plan_blocked_layout(counts, tm)
    if n_rows > _INT32_MAX:
        raise ValueError(f"payload too large for int32 rows: {n_rows}")
    n_slots = len(segments)
    sig = np.zeros((n_rows, w), np.uint32)
    slots = np.full(n_rows, _lane_pad(n_slots), np.int32)
    doc_idx = np.full(n_rows, -1, np.int64)
    within = (np.arange(int(counts.sum()))
              - np.repeat(np.cumsum(counts) - counts, counts))
    rows = np.repeat(row_starts, counts) + within
    sig[rows] = np.concatenate(
        [np.asarray(s, np.uint32).reshape(-1, w) for s, _ in segments])
    slots[rows] = np.repeat(np.arange(n_slots, dtype=np.int32), counts)
    doc_idx[rows] = np.concatenate(
        [np.asarray(d, np.int64).reshape(-1) for _, d in segments])
    block_slot = np.repeat(np.arange(n_slots, dtype=np.int32),
                           blocks).astype(np.int32)
    if shard_ids is None:
        shard_ids = range(n_slots)
    return MegascanPayload(
        sig=lsh_mod.to_packed_tensor(sig, dev),
        slots=torch.from_numpy(slots.reshape(1, -1)).to(dev),
        doc_idx=doc_idx, counts=counts, block_slot=block_slot,
        shard_ids=tuple(int(s) for s in shard_ids),
        tm=int(tm), n_slots=n_slots, n_blocks=int(block_slot.shape[0]),
        n_rows=int(n_rows),
        row_start=torch.from_numpy(row_starts.astype(np.int32)).to(dev),
        row_count=torch.from_numpy(counts.astype(np.int32)).to(dev))


def _operands(payload: MegascanPayload, queries, planes
              ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Queries and planes (tensors or arrays) as float32 tensors on the
    payload's device."""
    def on_dev(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(device=payload.sig.device, dtype=torch.float32)
    return on_dev(queries), on_dev(planes)


def megascan_segment_sums(payload: MegascanPayload, queries, planes,
                          bits: int, *, mode: str = "asym",
                          temperature: float = 1.0,
                          double_buffer: "bool | None" = None
                          ) -> np.ndarray:
    """One-launch per-(query, shard-slot) partial sums over the packed
    payload: [B, n_slots] float64.  ``mode="asym"`` takes [B, dim] real
    query vectors (any norm) and the hyperplanes; ``mode="hamming"``
    takes [B, W] packed query signatures (uint32 arrays or int32
    tensors; ``planes`` ignored).

    ``double_buffer`` picks the schedule: True (the default on CUDA)
    runs the megascan kernel over the slots' real-row ranges, False
    the segment sum of the mode over the payload's slot map.  The two
    are bitwise equal."""
    if mode == "asym":
        q_raw, pl_ = _operands(payload, queries, planes)
        b = 1 if q_raw.dim() == 1 else q_raw.shape[0]
    elif mode == "hamming":
        q_raw = lsh_mod.to_packed_tensor(queries, payload.sig.device)
        q_raw = q_raw[None, :] if q_raw.dim() == 1 else q_raw
        b = q_raw.shape[0]
    else:
        raise ValueError(f"unknown megascan mode {mode!r}")
    if payload.n_rows == 0:
        return np.zeros((b, payload.n_slots), np.float64)
    if double_buffer is None:
        double_buffer = payload.sig.is_cuda
    if not double_buffer:
        if mode == "asym":
            out = asym_ops.asym_exp_segment_sum(
                q_raw, payload.sig, pl_, bits, payload.slots.reshape(-1),
                payload.n_slots, temperature=temperature)
        else:
            out = hamming_ops.hamming_segment_similarity(
                q_raw, payload.sig, bits, payload.slots.reshape(-1),
                payload.n_slots, temperature=temperature)
    elif mode == "asym":
        q = asym_ops._prep_queries(q_raw)
        if common.on_cuda(q, payload.sig, pl_):
            out = _km.asym_megascan_segsum_kernel(
                q.contiguous(), pl_.contiguous(), payload.sig,
                payload.row_start, payload.row_count, bits,
                temperature=temperature)
        else:
            out = _mref.asym_megascan_segsum_ref(
                q, payload.sig, pl_, bits, payload.row_start,
                payload.row_count, temperature)
    elif common.on_cuda(q_raw, payload.sig):
        out = _km.hamming_megascan_segsum_kernel(
            q_raw.contiguous(), payload.sig, payload.row_start,
            payload.row_count, bits, temperature=temperature)
    else:
        out = _mref.hamming_megascan_segsum_ref(
            q_raw, payload.sig, bits, payload.row_start, payload.row_count,
            temperature)
    return out.cpu().numpy().astype(np.float64)


def per_slot_topk(cvals: torch.Tensor, cpos: torch.Tensor,
                  block_slot: np.ndarray, n_slots: int, k: int
                  ) -> "tuple[torch.Tensor, torch.Tensor]":
    """The final per-slot reduction of the ranked megascan, vectorised:
    [B, n_blocks*K] block candidates -> ([B, n_slots, k] values,
    [B, n_slots, k] payload positions), each slot's best k of its own
    blocks' candidates, value descending then candidate position
    ascending (the reference's stable argsort per slot).  Entries past
    a slot's candidate count are -inf / -1.

    A slot's blocks are contiguous (``block_slot`` is a repeat), so two
    stable sorts — by value, then by slot — leave every slot's
    candidates in a contiguous run, in the reference's order."""
    dev = cvals.device
    b, c = cvals.shape
    n_blocks = block_slot.shape[0]
    kc = c // n_blocks if n_blocks else 0
    nblk = torch.from_numpy(np.bincount(block_slot, minlength=n_slots)
                            .astype(np.int64)).to(dev)
    ncand = nblk * kc
    first = torch.cumsum(ncand, 0) - ncand
    cand_slot = torch.from_numpy(np.repeat(block_slot.astype(np.int64),
                                           kc)).to(dev)
    by_val = torch.sort(cvals, dim=1, descending=True, stable=True).indices
    by_slot = torch.sort(cand_slot[by_val], dim=1, stable=True).indices
    order = by_val.gather(1, by_slot)
    r = torch.arange(k, device=dev)
    valid = r[None, :] < ncand[:, None]                      # [S, k]
    cols = torch.where(valid, first[:, None] + r[None, :], 0).reshape(-1)
    pick = order[:, cols]                                    # [B, S*k]
    vals = cvals.gather(1, pick).reshape(b, n_slots, k)
    pos = cpos.to(torch.int64).gather(1, pick).reshape(b, n_slots, k)
    vals = torch.where(valid, vals, -torch.inf)
    pos = torch.where(valid, pos, -1)
    return vals, pos


def megascan_topk(payload: MegascanPayload, queries, planes, bits: int,
                  k: int, *, temperature: float = 1.0
                  ) -> "tuple[np.ndarray, np.ndarray]":
    """Ranked megascan (asym mode): per-(query, shard-slot) top-k doc
    ids + values in one launch.  Returns ([B, n_slots, k] int64 doc
    ids, [B, n_slots, k] float64 values); a slot with fewer than k docs
    pads with id -1 / value -inf.  The kernel emits only per-block
    candidates; ``per_slot_topk`` reduces them per slot."""
    q_raw, pl_ = _operands(payload, queries, planes)
    q = asym_ops._prep_queries(q_raw)
    b, k = q.shape[0], int(k)
    if payload.n_rows == 0 or k == 0:
        return (np.full((b, payload.n_slots, k), -1, np.int64),
                np.full((b, payload.n_slots, k), -np.inf, np.float64))
    if k > payload.tm:
        raise ValueError(f"k={k} exceeds payload tile tm={payload.tm}")
    slots = payload.slots.reshape(-1)
    if common.on_cuda(q, payload.sig, pl_):
        cvals, cpos = _km.asym_megascan_topk_kernel(
            q.contiguous(), pl_.contiguous(), payload.sig, slots, bits, k,
            payload.n_slots, payload.tm, temperature=temperature)
    else:
        cvals, cpos = _mref.asym_megascan_topk_ref(
            q, payload.sig, slots, pl_, bits, k, payload.n_slots,
            payload.tm, temperature)
    tv, tp = per_slot_topk(cvals, cpos, payload.block_slot,
                           payload.n_slots, k)
    tv, tp = tv.cpu().numpy(), tp.cpu().numpy()
    real = np.isfinite(tv)
    return (np.where(real, payload.doc_idx[np.maximum(tp, 0)], -1),
            np.where(real, tv.astype(np.float64), -np.inf))


# ----------------------------------------------------------------------
# executor-facing spec
# ----------------------------------------------------------------------
class MegascanSpec:
    """A batch of query scans the executor may run as ONE launch per
    shard group.  ``scan_fns()`` yields the per-query fns
    ``run_shared_scan`` expects; the composite closure it builds carries
    this spec, and a megakernel-enabled ``ShardTaskExecutor`` routes the
    whole group through ``run_group`` (one launch) instead of one task
    per shard.  ``run_shard`` is the per-shard parity reference — the
    same kernels on a single-shard payload, hence bit-for-bit equal
    partials.

    Results per (query, shard): a python float (sum mode) or a
    ``{"doc_ids": int64[k_s], "values": float64[k_s]}`` dict
    (ranked mode, ``k_s = min(k, shard doc count)``)."""

    def __init__(self, index, query_vecs, *, ranked_k: Optional[int] = None,
                 mode: Optional[str] = None, tm: int = 256,
                 temperature: Optional[float] = None):
        if index.doc_sig is None:
            raise ValueError("megascan needs doc signatures "
                             "(build_index(keep_doc_vectors=True))")
        self.index = index
        vecs = np.atleast_2d(np.asarray(query_vecs, np.float32))
        self.n_queries = vecs.shape[0]
        self.mode = mode or ("asym" if index.lsh_mode == "asym"
                             else "hamming")
        if self.mode not in ("asym", "hamming"):
            raise ValueError(f"unknown megascan mode {self.mode!r}")
        if ranked_k is not None and self.mode != "asym":
            raise ValueError("ranked megascan requires asym mode")
        self.ranked_k = ranked_k
        self.tm = int(tm)
        self.temperature = float(index.temperature if temperature is None
                                 else temperature)
        self.planes = index._device_planes()
        if self.mode == "asym":
            self.queries = torch.as_tensor(vecs, device=index.device)
        else:
            self.queries = index.query_sig_tensor(vecs)
        self.stats: Dict[str, int] = {"group_launches": 0,
                                      "shard_launches": 0}
        self.last_record: Optional[dict] = None

    # -- payloads ------------------------------------------------------
    def _payload(self, shard_ids: Tuple[int, ...]) -> MegascanPayload:
        return self.index.megascan_payload(shard_ids, tm=self.tm)

    # -- compute -------------------------------------------------------
    def _scan(self, payload: MegascanPayload):
        """Run the scan over one payload; returns the dense per-slot
        arrays (sum mode [B, S] or ranked ([B, S, k], [B, S, k]))."""
        if self.ranked_k is None:
            return megascan_segment_sums(
                payload, self.queries, self.planes, self.index.bits,
                mode=self.mode, temperature=self.temperature)
        return megascan_topk(
            payload, self.queries, self.planes, self.index.bits,
            self.ranked_k, temperature=self.temperature)

    def _extract(self, payload: MegascanPayload, dense, slot: int,
                 qi: int):
        if self.ranked_k is None:
            return float(dense[qi, slot])
        ids, vals = dense
        k_s = int(min(self.ranked_k, payload.counts[slot]))
        return {"doc_ids": np.asarray(ids[qi, slot, :k_s]),
                "values": np.asarray(vals[qi, slot, :k_s])}

    def _flops(self, payload: MegascanPayload) -> int:
        """Operations of the scan as the CUDA kernels do it, over the
        real rows (no padding row is scored) with one add per (query,
        real row).  asym sum: the fp32 query projection, the 4-bit
        lookup tables (16 entries of 3 adds per query and chunk) and one
        table add per (query, real row, chunk), bits/4 of them; asym
        ranked: the projection and the +-1 dot, 2 * bits per (query,
        real row); hamming: an XOR, a popcount and an add per (query,
        real row, word).  The reference's count adds its one-hot
        reduction over the padded payload, which has no counterpart
        here."""
        b = self.n_queries
        bits = int(self.index.bits)
        rows = payload.real_rows
        if self.mode == "hamming":
            return 3 * b * rows * int(payload.sig.shape[1]) + b * rows
        proj = 2 * b * bits * int(self.planes.shape[1])
        if self.ranked_k is not None:
            return proj + 2 * b * rows * bits + b * rows
        chunks = bits // 4
        return proj + 48 * b * chunks + b * rows * chunks + b * rows

    def run_group(self, shard_ids: Sequence[int],
                  queries_of: Dict[int, Iterable[int]]) -> dict:
        """ONE launch for the whole shard group; returns
        ``{shard_id: {query_index: result}}`` — exactly the layout the
        shared-scan gather consumes."""
        ids = tuple(int(s) for s in shard_ids)
        payload = self._payload(ids)
        t0 = time.perf_counter()
        dense = self._scan(payload)
        wall = time.perf_counter() - t0
        self.stats["group_launches"] += 1
        self.last_record = {
            "kind": "megascan", "mode": self.mode,
            "ranked": self.ranked_k is not None, "launches": 1,
            "shards": len(ids), "blocks": payload.n_blocks,
            "rows": payload.n_rows, "real_rows": payload.real_rows,
            "queries": self.n_queries, "tm": payload.tm,
            "double_buffer": payload.sig.is_cuda,
            "bytes_streamed": payload.nbytes_streamed,
            "flops": self._flops(payload), "wall_s": wall,
        }
        out: Dict[int, dict] = {}
        for slot, sid in enumerate(ids):
            out[sid] = {qi: self._extract(payload, dense, slot, qi)
                        for qi in queries_of.get(sid, ())}
        return out

    def run_shard(self, shard_id: int, query_ids: Iterable[int]) -> dict:
        """Per-shard parity reference: one launch for THIS shard only,
        the same kernels and padding as the group path."""
        payload = self._payload((int(shard_id),))
        dense = self._scan(payload)
        self.stats["shard_launches"] += 1
        return {qi: self._extract(payload, dense, 0, qi)
                for qi in query_ids}

    # -- shared-scan integration --------------------------------------
    def scan_fns(self):
        """Per-query scan fns for ``run_shared_scan``; each carries this
        spec so spec-aware layers can fuse the whole batch."""
        fns = []
        for qi in range(self.n_queries):
            def fn(shard, _qi=qi):
                return self.run_shard(shard.shard_id, (_qi,))[_qi]
            fn.megascan = self
            fn.query_index = qi
            fns.append(fn)
        return fns
