"""Worker processes of the port's multi-process CPU tests: gloo over a
``FileStore`` in the test's temporary directory (no TCP port), one
thread each.

    PYTHONPATH=src:tests python tests/_torch_dist.py <job> <rank> <world> <dir>

``spawn(job, world, dir)`` starts ``world`` ranks of ``job`` and returns
what each rank saved (``torch.save``) to ``<dir>/<job>.<rank>.pt``;
``single_process`` / ``single_process_grads`` give the single-process
step the test holds each case to, and ``python tests/_torch_dist.py
readings <dir>`` prints every case's error against it.
Jobs:

  step      8 ranks: the sharded train step (smoke width, fp32
            policy, warmup 0, 3 steps) of each of ``STEP_CASES``, from
            ``step_setup``'s state and batch, tensor-parallel over
            ``model`` where a sublayer's dim divides: smollm on a (4, 2)
            (data, model) mesh and a (2, 2, 2) (pod, data, model) mesh
            with micro-batches 1 and 2 (attention split by heads),
            smollm on a (2, 4) mesh (its 2 KV heads do not divide 4:
            the query-sequence split) and qwen2.5 (QKV bias) on the
            (4, 2) mesh, and a grouped (VLM) and an SSM arch
            on the (2, 2, 2) mesh (Whisper, the encoder-decoder, is
            left out: its smoke model moves 0.45 of a leaf's max under
            one ulp of its parameters, which no bound can hold; its
            sharded step read 1.6e-4 from the single-process one); the
            MoE family expert-parallel: Scout on the (4, 2) mesh with
            micro-batches 1 and 2 and once at capacity factor 0.5 (the
            drops of each rank's MoE calls are saved) and once with
            micro-batches 2 and ``MASKED_ROWS`` masked whole (in the
            first micro-batch one data rank has no unmasked row, the
            second has none at all), Maverick on the (2, 2, 2) mesh;
            mamba2 and the VLM also on the (2, 4) mesh (the SSM split
            by heads; the VLM's 2 KV heads do not divide 4, so its
            cross-attention splits the decoder rows);
  serve     4 ranks: the sharded prefill and decode
            (``make_prefill_step`` / ``make_decode_step`` with a mesh)
            of each of ``SERVE_CASES`` at smoke width, fp32: a prefill
            of ``SERVE_PROMPT`` tokens and ``SERVE_STEPS`` decode steps
            of a batch of ``SERVE_BATCH``, the state placed by
            ``decode_state_shardings``: smollm on the (2, 2) and (1, 4)
            (data, model) meshes (the caches' slots split over
            ``model``: context-parallel attention), mamba2 and hymba on
            (2, 2) (the SSM and its state split by heads), hymba with
            ``ssm_state`` 9 on (1, 4) (``in_proj``'s 282 columns do not
            divide 4: the mixer computes whole, its state chunks
            gathered and written back, hymba-1.5b's case on 16 ranks),
            Scout (expert-parallel) on (2, 2) and the VLM
            (cross-attention by decoder rows, then whole) on (1, 4);
            saved: each call's logits, the whole state, the collectives
            and gathered leaves of each step;
  compress  4 ranks: ``compressed_psum`` over a 4-rank axis on
            ``compress_inputs``, and ``shard_constraint`` on a DTensor
            of a (2, 2) mesh.
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA_MODEL = ((4, 2), ("data", "model"))
POD_DATA_MODEL = ((2, 2, 2), ("pod", "data", "model"))
DATA_MODEL4 = ((2, 4), ("data", "model"))   # 2 KV heads: the seq split
SCOUT, MAVERICK = "llama4_scout_17b_a16e", "llama4_maverick_400b_a17b"
DROP_CF = 0.5               # the capacity factor of the case with drops
MASKED_ROWS = (2, 4, 5, 6, 7)  # rows masked whole in one case
# (arch, mesh, micro-batches[, capacity factor[, rows masked whole]])
STEP_CASES = tuple(("smollm_360m", mesh, mb)
                   for mesh in (DATA_MODEL, POD_DATA_MODEL) for mb in (1, 2)) \
    + (("smollm_360m", DATA_MODEL4, 1), ("qwen2_5_14b", DATA_MODEL, 1)) \
    + tuple((arch, POD_DATA_MODEL, 2) for arch in
            ("llama_3_2_vision_11b", "mamba2_780m")) \
    + tuple((arch, DATA_MODEL4, 1) for arch in
            ("mamba2_780m", "llama_3_2_vision_11b")) \
    + ((SCOUT, DATA_MODEL, 1), (SCOUT, DATA_MODEL, 2),
       (MAVERICK, POD_DATA_MODEL, 2), (SCOUT, DATA_MODEL, 1, DROP_CF),
       (SCOUT, DATA_MODEL, 2, None, MASKED_ROWS))
STEP_COUNT = 3
STEP_LR = 1e-3
STEP_SEQ = 16
# archs whose parameters after the steps cannot be held to the
# single-process step's: qwen2.5's zero-initialised QKV biases leave
# entries whose AdamW update flips sign under one ulp of the parameters
# (the single-process step's own move reads 1.0e-2); their first step's
# loss and gradients are held instead
GRADS_ONLY = ("qwen2_5_14b",)


# the serve job's 4 ranks: (2, 2) and (1, 4) (data, model) meshes
SERVE_WORLD = 4
SERVE_2X2 = ((2, 2), ("data", "model"))
SERVE_1X4 = ((1, 4), ("data", "model"))
# (arch, mesh, config changes as sorted pairs)
SERVE_CASES = (("smollm_360m", SERVE_2X2, ()), ("smollm_360m", SERVE_1X4, ()),
               ("mamba2_780m", SERVE_2X2, ()), ("hymba_1_5b", SERVE_2X2, ()),
               ("hymba_1_5b", SERVE_1X4, (("ssm_state", 9),)),
               (SCOUT, SERVE_2X2, ()),
               ("llama_3_2_vision_11b", SERVE_1X4, ()))
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 16, 4
SERVE_CALLS = ((0, SERVE_PROMPT),) + tuple(
    (i, i + 1) for i in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_STEPS))


def case_id(case) -> str:
    arch, (sizes, names), mb = case[:3]
    cf = f"-cf{case[3]}" if len(case) > 3 and case[3] is not None else ""
    masked = "-masked" if len(case) > 4 else ""
    shape = "" if case[1] in (DATA_MODEL, POD_DATA_MODEL) else \
        "-" + "x".join(map(str, sizes))
    return f"{arch}-{'x'.join(names)}{shape}-mb{mb}{cf}{masked}"


def step_setup(arch: str, capacity_factor=None, masked_rows=()):
    """(cfg, opt_cfg, params, batch) of the step job: ``arch`` at smoke
    width under the fp32 policy (at ``capacity_factor`` where given),
    seeded parameters, a batch of 8 x 16 whose row r has its last r
    tokens masked (so the ranks' mask counts differ) and the rows
    ``masked_rows`` masked whole, with seeded encoder inputs where the
    family takes them."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import DTypePolicy
    from repro_torch.optimizer.adamw import AdamWConfig
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtypes=DTypePolicy("float32", "float32",
                                                 "float32"))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    params = M.init_stacked_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    rng = np.random.default_rng(5)
    b, s = 8, STEP_SEQ
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    mask = torch.ones((b, s))
    for r in range(b):
        mask[r, s - r:] = 0.0
    mask[list(masked_rows)] = 0.0
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    if cfg.is_encdec or cfg.family == "vlm":
        t = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
        batch["enc_inputs"] = torch.from_numpy(rng.standard_normal(
            (b, t, cfg.d_model)).astype(np.float32))
    return cfg, AdamWConfig(lr=STEP_LR), params, batch


def run_steps(step, params, opt_state, batch, n: int = STEP_COUNT):
    losses = []
    for _ in range(n):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    return params, opt_state, losses


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@functools.lru_cache(maxsize=None)
def single_process(arch: str, mb: int, *cf):
    """The single-process step's parameters and losses after the job's
    steps, and its one-ulp moves: the largest relative change of a leaf
    and of a loss when every parameter moves one ulp."""
    from repro_torch.launch import steps as ST
    from repro_torch.optimizer.adamw import adamw_init
    from repro_torch.utils.trees import tree_leaves, tree_map
    cfg, opt_cfg, params, batch = step_setup(arch, *cf)
    step = ST.make_train_step(cfg, opt_cfg, microbatches=mb, warmup_steps=0,
                              total_steps=STEP_COUNT)
    p, _, losses = run_steps(step, params, adamw_init(params, opt_cfg),
                             batch)
    g = torch.Generator().manual_seed(7)
    inf = torch.tensor(float("inf"))
    nudged = tree_map(lambda x: torch.nextafter(
        x, torch.where(torch.rand(x.shape, generator=g) < 0.5, inf, -inf)),
        params)
    pu, _, lu = run_steps(step, nudged, adamw_init(nudged, opt_cfg), batch)
    move = max(rel(a, b) for a, b in zip(tree_leaves(pu), tree_leaves(p)))
    lmove = max(abs(a - b) / abs(b) for a, b in zip(lu, losses))
    return p, losses, move, lmove


@functools.lru_cache(maxsize=None)
def single_process_grads(arch: str):
    """The single-process loss and gradients at the job's initial
    parameters and batch, and the gradients' largest relative move
    under one ulp of the parameters."""
    from repro_torch.launch import steps as ST
    from repro_torch.utils.trees import tree_leaves, tree_map
    cfg, _, params, batch = step_setup(arch)
    loss, grads = ST._value_and_grad(params, batch, cfg)
    g = torch.Generator().manual_seed(7)
    inf = torch.tensor(float("inf"))
    nudged = tree_map(lambda x: torch.nextafter(
        x, torch.where(torch.rand(x.shape, generator=g) < 0.5, inf, -inf)),
        params)
    _, moved = ST._value_and_grad(nudged, batch, cfg)
    move = max(rel(a, b) for a, b in zip(tree_leaves(moved),
                                         tree_leaves(grads)))
    return float(loss), tree_leaves(grads), move


def serve_id(case) -> str:
    arch, (sizes, names), changes = case
    extra = "".join(f"-{k}{v}" for k, v in changes)
    return f"{arch}-{'x'.join(map(str, sizes))}{extra}"


def serve_setup(arch: str, changes=()):
    """(cfg, stacked parameters, tokens [B, prompt + steps], encoder
    context or None) of the serve job: ``arch`` at smoke width, fp32,
    with ``changes``; the VLM's vision embeddings drawn, Whisper's
    encoder output from drawn frames."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import DTypePolicy
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtypes=DTypePolicy("float32", "float32",
                                                 "float32"), **dict(changes))
    params = M.init_stacked_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + SERVE_STEPS)))
    enc = None
    if cfg.is_encdec or cfg.family == "vlm":
        t = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
        enc = torch.from_numpy(rng.standard_normal(
            (SERVE_BATCH, t, cfg.d_model)).astype(np.float32))
        if cfg.is_encdec:
            enc = M.encode(M._unstack_params(params), enc, cfg)
    return cfg, params, toks, enc


def _serve_calls(cfg, params, toks, enc):
    from repro_torch.models import model as M
    views = M._unstack_params(params)
    state = M.init_decode_state(cfg, SERVE_BATCH,
                                SERVE_PROMPT + SERVE_STEPS, enc=enc,
                                device="cpu")
    logits = []
    for a, e in SERVE_CALLS:
        fn = M.prefill if a == 0 else M.decode_step
        out, state = fn(views, toks[:, a:e], cfg, state)
        logits.append(out)
    return logits, state


@functools.lru_cache(maxsize=None)
def single_process_serve(arch: str, changes=()):
    """The unsharded ``prefill`` / ``decode_step``'s logits of each of
    ``SERVE_CALLS``, the state after them, and the logits' largest
    relative move when every parameter moves one ulp (the smoke models
    at their init scale move 4.9e-6 to 4.9e-5)."""
    from repro_torch.utils.trees import tree_map
    cfg, params, toks, enc = serve_setup(arch, changes)
    logits, state = _serve_calls(cfg, params, toks, enc)
    g = torch.Generator().manual_seed(7)
    inf = torch.tensor(float("inf"))
    nudged = tree_map(lambda x: torch.nextafter(
        x, torch.where(torch.rand(x.shape, generator=g) < 0.5, inf, -inf)),
        params)
    moved, _ = _serve_calls(cfg, nudged, toks, enc)
    return logits, state, max(rel(a, b) for a, b in zip(moved, logits))


def compress_inputs(rank: int):
    """(x, error) of one rank of the compress job."""
    rng = np.random.default_rng(100 + rank)
    x = rng.standard_normal((3, 300)).astype(np.float32)
    err = (rng.standard_normal((3, 300)) * 1e-3).astype(np.float32)
    return x, err


def _job_step():
    import time
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import full_tree, place_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import moe as Mo
    from repro_torch.optimizer.adamw import adamw_init
    from repro_torch.utils.trees import tree_leaves
    from torch.distributed.tensor import DTensor
    meshes = {m: init_device_mesh("cpu", m[0], mesh_dim_names=m[1])
              for m in (DATA_MODEL, POD_DATA_MODEL, DATA_MODEL4)}
    drops = []
    routed = Mo.expert_range_output

    def counted(w, tokens, gate_vals, expert_idx, places, *rest):
        capacity = rest[-2]
        drops.append(int((places >= capacity).sum()))
        return routed(w, tokens, gate_vals, expert_idx, places, *rest)
    Mo.expert_range_output = counted
    out = {}
    for case in STEP_CASES:
        arch, m, mb = case[:3]
        cfg, opt_cfg, params, batch = step_setup(arch, *case[3:])
        mesh = meshes[m]
        t0 = time.perf_counter()
        step = ST.make_train_step(cfg, opt_cfg, microbatches=mb,
                                  warmup_steps=0, total_steps=STEP_COUNT,
                                  mesh=mesh)
        p = place_tree(params, ST.params_shardings(cfg, mesh))
        o = place_tree(adamw_init(params, opt_cfg),
                       ST.opt_state_shardings(cfg, mesh))
        first = {}
        if arch in GRADS_ONLY:
            grads = ST.make_sharded_grads(cfg, mesh, mb)
            shardings = tree_leaves(ST.params_shardings(cfg, mesh))
            loss0, g0 = grads(place_tree(params, ST.params_shardings(
                cfg, mesh)), batch)
            first = {"loss0": float(loss0), "grads": [
                DTensor.from_local(g, mesh, sh.placements, run_check=False,
                                   shape=a.shape, stride=a.stride())
                .full_tensor() for g, sh, a in
                zip(g0, shardings, tree_leaves(params))]}
        drops.clear()
        p, o, losses = run_steps(step, p, o, batch)
        out[case] = {"params": full_tree(p), "losses": losses,
                     "collectives": step.collectives.kinds,
                     "gathered": {a: sorted(v) for a, v in
                                  step.collectives.gathered.items()},
                     "local_tok_emb": tuple(p["tok_emb"].to_local().shape),
                     "wall_s": time.perf_counter() - t0, **first}
        if cfg.family == "moe":
            moe = (p["groups"]["moe"] if "groups" in p else p["layers"])
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, (coord, sum(drops)))
            out[case].update(drops=every, local_w_gate=tuple(
                moe["moe"]["w_gate"].to_local().shape))
    return out


def _job_serve():
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import full_tree, place_tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.utils.trees import tree_leaves
    meshes = {m: init_device_mesh("cpu", m[0], mesh_dim_names=m[1])
              for m in (SERVE_2X2, SERVE_1X4)}
    max_len = SERVE_PROMPT + SERVE_STEPS
    out = {}
    for case in SERVE_CASES:
        arch, m, changes = case
        cfg, params, toks, enc = serve_setup(arch, changes)
        mesh = meshes[m]
        steps = {"prefill": ST.make_prefill_step(cfg, mesh),
                 "decode": ST.make_decode_step(cfg, mesh)}
        p = place_tree(params, ST.params_shardings(cfg, mesh, serve=True))
        abstract = ST.abstract_decode_state(cfg, SERVE_BATCH, max_len,
                                            enc is not None)
        state = place_tree(
            M.init_decode_state(cfg, SERVE_BATCH, max_len, enc=enc,
                                device="cpu"),
            ST.decode_state_shardings(cfg, mesh, abstract, SERVE_BATCH))
        logits = []
        for a, e in SERVE_CALLS:
            out_, state = steps["prefill" if a == 0 else "decode"](
                p, toks[:, a:e], state)
            logits.append(out_)
        local = [tuple(t.to_local().shape)
                 for t in tree_leaves((state.kv, state.ssm))]
        out[case] = {"logits": logits, "state": full_tree(state),
                     "local_shapes": local,
                     "collectives": {k: f.collectives.kinds
                                     for k, f in steps.items()},
                     "gathered": {k: {a: sorted(v) for a, v in
                                      f.collectives.gathered.items()}
                                  for k, f in steps.items()}}
    return out


def _job_compress(rank: int):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.distributed.sharding import shard_constraint, use_mesh
    ring = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    x, err = compress_inputs(rank)
    total, new_err = compressed_psum(torch.from_numpy(x), "pod",
                                     torch.from_numpy(err), mesh=ring)
    grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    d = distribute_tensor(torch.arange(12.0).reshape(3, 4), grid,
                          [Replicate(), Replicate()], src_data_rank=None)
    with use_mesh(grid):
        got = shard_constraint(d, "batch", "d_ff")
        plain = torch.ones(3, 4)
        same = shard_constraint(plain, "batch", "d_ff") is plain
    return {"sum": total, "new_error": new_err,
            "placements": [repr(p) for p in got.placements],
            "local": got.to_local(), "plain_is_same": same}


def spawn(job: str, world: int, tmp: pathlib.Path, timeout: float = 240):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r),
                               str(world), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, bad[0]
    return [torch.load(tmp / f"{job}.{r}.pt", weights_only=False)
            for r in range(world)]


def main(job: str, rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, f"{job}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {"step": _job_step, "serve": _job_serve,
               "compress": lambda: _job_compress(rank)}[job]()
        torch.save(out, os.path.join(tmp, f"{job}.{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def readings(tmp: str) -> None:
    """Print each step case's largest relative error against the
    single-process step and that step's own one-ulp move (parameters
    after the steps and losses; the first step's gradients for
    ``GRADS_ONLY``), and the case's wall in the job."""
    from repro_torch.utils.trees import tree_leaves
    runs = spawn("step", 8, pathlib.Path(tmp))[0]
    for case in STEP_CASES:
        got, arch, mb = runs[case], case[0], case[2]
        if arch in GRADS_ONLY:
            loss, grads, move = single_process_grads(arch)
            err = max(rel(a, b) for a, b in zip(got["grads"], grads))
            what = (f"first-step gradients {err:.3g} (move {move:.3g}), "
                    f"loss {abs(got['loss0'] - loss) / abs(loss):.3g}")
        else:
            p, losses, move, lmove = single_process(arch, mb, *case[3:])
            err = max(rel(a, b) for a, b in zip(tree_leaves(got["params"]),
                                                tree_leaves(p)))
            lerr = max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], losses))
            what = (f"parameters {err:.3g} (move {move:.3g}), losses "
                    f"{lerr:.3g} (move {lmove:.3g})")
        print(f"{case_id(case)}: {what}; {got['wall_s']:.2f} s")


if __name__ == "__main__":
    # python tests/_torch_dist.py readings <dir>: the step job's readings
    if sys.argv[1] == "readings":
        readings(sys.argv[2])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
