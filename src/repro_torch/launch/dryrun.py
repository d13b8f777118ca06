"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell on
the production meshes, with no device.

    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod both] [--out results/torch_dryrun]

Each cell writes one JSON under ``--out`` (resumable: a cell with
status ok or skipped is not run again unless ``--force``):

  * the status: ok, skipped with the reason (``cell_is_supported``), or
    error with its traceback;
  * ``n_devices`` and, for train cells, ``microbatches``;
  * ``memory``: per-device bytes of the parameters, the optimizer state
    (train), the batch or tokens, and the decode state (serve), each
    the sum over the legalized trees' leaves of their ``shard_shape``
    (shape arithmetic on an ``AbstractMesh``);
  * ``probe``: one rank's local sharded step run on rank 0 of a fake
    world of the mesh's size under ``FakeTensorMode`` (nothing is
    allocated, no collective moves data): its flops
    (``FlopCounterMode``), its peak live bytes (the storages its ops
    create, the local state included) and the collectives it launches
    by kind (count, bytes).  Train cells run
    ``launch/steps.make_train_step(mesh=)``: the batch split over the
    batch axes, tensor-parallel over ``model``: each self- and
    cross-attention by heads (or, where the head counts do not divide
    ``model``, by query rows, the K/V projections whole), the SSM by
    heads, the MLPs over ``d_ff``, the embedding, head and loss over
    ``vocab``, the MoE's experts over ``model``, each where its dim
    divides; the norms and the MoE router (replicated in the reference
    too) run whole on every ``model`` rank, and so does whatever does
    not divide.  Serve cells run ``make_prefill_step(mesh=)`` /
    ``make_decode_step(mesh=)``: the parameters placed for serving (no
    ``fsdp``), the state by ``decode_state_shardings``, the caches'
    slots over ``model`` (context-parallel attention: a prefill splits
    the query rows, a decode step scores its slots and joins them by
    log-sum-exp), the rest split as in training; a decode cell at a
    full cache (length ``seq_len - 1``), a prefill from an empty one.
    The reference's two-point depth probe: the step at 1 and 2 layer
    units (``_probe_cfg``), total = outer + units x per unit
    (``_layer_units``).  Where the fake run raises, the cell is an
    error;
  * ``fits_80gb``: the cell's peak live bytes (state included) within
    one H100's 80 GB (80e9 bytes).

A configuration with no sharded step (``steps.refuse_unsharded``: the
port's interleaved Granite 4.0-H) is refused: ``run_cell`` raises
``NotImplementedError``, which ``main`` records as the cell's error.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Dict

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import AbstractMesh, NamedSharding, P
from repro_torch.launch import specs as S
from repro_torch.launch import steps as ST
from repro_torch.optimizer.adamw import AdamWConfig, adamw_init
from repro_torch.utils.trees import tree_leaves, tree_unflatten

H100_BYTES = 80e9
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def tree_shard_bytes(shardings, abstract) -> int:
    """Per-device bytes of ``abstract``'s tensors placed by the
    ``NamedSharding``s in the same places of ``shardings``."""
    return sum(math.prod(sh.shard_shape(tuple(a.shape))) * a.element_size()
               for sh, a in zip(tree_leaves(shardings), tree_leaves(abstract))
               if isinstance(a, torch.Tensor))


def _probe_cfg(cfg, k: int):
    """Reduced-depth config for cost probes: ``k`` layer units."""
    if cfg.family == "vlm" and cfg.cross_attn_every > 0:
        n = k * cfg.cross_attn_every
    elif cfg.family == "moe" and cfg.moe_every > 1:
        n = k * cfg.moe_every
    else:
        n = k
    repl = dict(n_layers=n, scan_layers=False)
    if cfg.is_encdec:
        repl["encoder_layers"] = k
    return dataclasses.replace(cfg, **repl)


def _layer_units(cfg) -> int:
    """How many probe units the full model has (layers / groups)."""
    if cfg.family == "vlm" and cfg.cross_attn_every > 0:
        return cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "moe" and cfg.moe_every > 1:
        return cfg.n_layers // cfg.moe_every
    return cfg.n_layers


def _cell_cfg(cfg, shape: str):
    """Chunked attention for long-sequence prefill, bf16 weights for
    serving (no optimizer, no master copy)."""
    if S.SHAPES[shape].kind == "prefill" and S.SHAPES[shape].seq_len >= 8192:
        cfg = dataclasses.replace(cfg, attn_impl="chunked")
    if S.SHAPES[shape].kind in ("prefill", "decode"):
        cfg = dataclasses.replace(
            cfg, dtypes=dataclasses.replace(cfg.dtypes, params="bfloat16"))
    return cfg


class _LiveBytes:
    """Peak bytes of the storages alive at once among those the ops run
    under ``mode()`` create (each storage counted once, until freed)."""

    def __init__(self):
        self.live = self.peak = 0
        self._ids: set = set()

    def mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        track = self._track

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in torch.utils._pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        track(t.untyped_storage())
                return out
        return Mode()

    def _track(self, st) -> None:
        key = id(st)
        if key in self._ids:
            return
        n = st.nbytes()
        self._ids.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._ids.discard(key)
        self.live -= n


@contextlib.contextmanager
def _fake_world(shape, names):
    """Rank 0 of a fake process group of the mesh's size, and the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _shards(shardings, abstract):
    """``abstract``'s tree with each tensor a zero tensor of its shard
    shape under the sharding in the same place (other leaves kept)."""
    return tree_unflatten(abstract, [
        torch.zeros(sh.shard_shape(tuple(a.shape)), dtype=a.dtype)
        if isinstance(a, torch.Tensor) else a
        for sh, a in zip(tree_leaves(shardings), tree_leaves(abstract))])


def _local_step_costs(cfg, shape: str, mesh, microbatches: int) -> Dict:
    """Flops, peak live bytes and collectives of one rank's sharded
    step of the cell's kind on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    cell = S.SHAPES[shape]
    live = _LiveBytes()
    flops = FlopCounterMode(display=False)
    # the abstract trees (and the shardings, legalized against them)
    # are built outside the modes: the live bytes would count their
    # meta tensors' whole (unsharded) sizes
    abstract = ST.abstract_params(cfg)
    if cell.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=cfg.dtypes.opt_state)
        step = ST.make_train_step(cfg, opt_cfg, microbatches=microbatches,
                                  mesh=mesh)
        shardings = ST.params_shardings(cfg, mesh)
        with FakeTensorMode(), flops, live.mode():
            params = _shards(shardings, abstract)
            opt_state = adamw_init(params, opt_cfg)
            batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                     for k, v in S.train_input_specs(cfg, shape).items()}
            step(params, opt_state, batch)
    else:
        prefill = cell.kind == "prefill"
        step = (ST.make_prefill_step if prefill
                else ST.make_decode_step)(cfg, mesh)
        max_len = S.effective_max_len(cfg, shape)
        astate = ST.abstract_decode_state(
            cfg, cell.global_batch, max_len,
            cfg.is_encdec or cfg.family == "vlm")
        st_sh = ST.decode_state_shardings(cfg, mesh, astate,
                                          cell.global_batch)
        tok = S.serve_token_spec(cfg, shape)
        shardings = ST.params_shardings(cfg, mesh, serve=True)
        with FakeTensorMode(), flops, live.mode():
            params = _shards(shardings, abstract)
            state = _shards(st_sh, astate)._replace(
                length=0 if prefill else max_len - 1)
            step(params, torch.zeros(tok.shape, dtype=tok.dtype), state)
    return {"flops": float(flops.get_total_flops()),
            "peak_bytes": float(live.peak),
            "colls": step.collectives.kinds}


def cost_probe(cfg, shape: str, mesh, microbatches: int) -> Dict:
    """Two-point depth probe: the step at 1 and 2 layer units, total =
    outer + units * per unit (clamped at 0 per unit)."""
    probes = {k: _local_step_costs(_probe_cfg(cfg, k), shape, mesh,
                                   microbatches) for k in (1, 2)}
    units = _layer_units(cfg)

    def extrapolate(a: float, b: float) -> Dict[str, float]:
        per_unit = max(b - a, 0.0)
        outer = max(a - per_unit, 0.0)
        return {"per_layer_unit": per_unit, "outer": outer,
                "total": outer + units * per_unit}

    out = {"units": units,
           "flops": extrapolate(probes[1]["flops"], probes[2]["flops"]),
           "peak_bytes": extrapolate(probes[1]["peak_bytes"],
                                     probes[2]["peak_bytes"])}
    colls = {}
    for kind in sorted(set(probes[1]["colls"]) | set(probes[2]["colls"])):
        one = probes[1]["colls"].get(kind, {"count": 0, "bytes": 0})
        two = probes[2]["colls"].get(kind, {"count": 0, "bytes": 0})
        colls[kind] = {k: extrapolate(one[k], two[k])["total"]
                       for k in ("count", "bytes")}
    out["collectives"] = colls
    return out


def run_cell(arch: str, shape: str, multi_pod: bool) -> Dict:
    cfg = get_config(arch)
    ST.refuse_unsharded(cfg)
    tag = "multi" if multi_pod else "single"
    ok, reason = S.cell_is_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": tag,
                "status": "skipped", "reason": reason}
    t0 = time.time()
    cfg = _cell_cfg(cfg, shape)
    sizes, names = MESHES[multi_pod]
    mesh = AbstractMesh(sizes, names)
    cell = S.SHAPES[shape]
    with_enc = cfg.is_encdec or cfg.family == "vlm"
    result = {"arch": arch, "shape": shape, "mesh": tag, "status": "ok",
              "n_devices": mesh.size,
              "params_estimate": cfg.param_count_estimate(),
              "active_params_estimate": cfg.active_param_count_estimate()}
    mem = {"param_bytes": tree_shard_bytes(ST.params_shardings(cfg, mesh),
                                           ST.abstract_params(cfg))}
    result["memory"] = mem
    mb = 1
    if cell.kind == "train":
        mb = S.microbatches_for(cfg, shape)
        result["microbatches"] = mb
        opt_cfg = AdamWConfig(state_dtype=cfg.dtypes.opt_state)
        mem["opt_state_bytes"] = tree_shard_bytes(
            ST.opt_state_shardings(cfg, mesh),
            ST.abstract_opt_state(cfg, opt_cfg))
        mem["batch_bytes"] = tree_shard_bytes(
            ST.batch_shardings(cfg, mesh, cell.global_batch, with_enc),
            S.train_input_specs(cfg, shape))
    else:
        astate = ST.abstract_decode_state(cfg, cell.global_batch,
                                          S.effective_max_len(cfg, shape),
                                          with_enc)
        mem["decode_state_bytes"] = tree_shard_bytes(
            ST.decode_state_shardings(cfg, mesh, astate, cell.global_batch),
            astate)
        ba = ST.batch_axes(mesh, cell.global_batch)
        mem["token_bytes"] = tree_shard_bytes(
            [NamedSharding(mesh, P(ba if ba else None, None))],
            [S.serve_token_spec(cfg, shape)])
    try:
        with _fake_world(sizes, names) as dmesh:
            probe = cost_probe(cfg, shape, dmesh, mb)
    except Exception as e:  # noqa: BLE001 - recorded in the cell
        result.update(status="error", error=str(e),
                      traceback=traceback.format_exc()[-2000:])
        return result
    result["probe"] = probe
    result["collectives"] = probe["collectives"]
    result["flops"] = probe["flops"]["total"]
    result["peak_live_bytes"] = probe["peak_bytes"]["total"]
    result["fits_80gb"] = probe["peak_bytes"]["total"] <= H100_BYTES
    result["wall_s"] = round(time.time() - t0, 2)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(S.SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = (f"{arch.replace('-', '_')}__{shape}__"
                       f"{'multi' if mp else 'single'}")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    try:
                        with open(path) as f:
                            prev = json.load(f)
                    except (OSError, ValueError):
                        prev = {}
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip existing] {tag}")
                        continue   # errors are retried
                print(f"[cell] {tag}", flush=True)
                try:
                    res = run_cell(arch, shape, mp)
                except Exception as e:  # noqa: BLE001 - one cell's failure
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()[-2000:]}
                if res["status"] == "error":
                    failures += 1
                    print(f"  ERROR: {res['error']}", flush=True)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
