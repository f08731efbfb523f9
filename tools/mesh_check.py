#!/usr/bin/env python3
"""Sharded training and serving under a ("data", "model") mesh against
the same steps unsharded, one process a rank: on the CPU over gloo at
the smoke configs (``tests/test_torch_mesh.py`` runs it so), or on the
cards over NCCL, one card a rank, at Qwen3-1.7B's full width.

    PYTHONPATH=src python tools/mesh_check.py --device cpu   # 4 gloo ranks
    python3 tools/mesh_check.py                              # 4 cards, NCCL

Every rank holds the unsharded state (plain tensors, seeded alike) and
the same state placed on the mesh (``train.step.place_train_state``),
runs one train step of ``MICRO`` microbatches on each, and checks:

- in f32 (the master weights unconverted: ``cast_for_compute`` replaced
  by the identity) the loss within ``F32_TOL`` relative, and every
  gradient's ``full_tensor()`` within ``F32_TOL`` of that tensor's
  largest value in the unsharded step, or, where the unsharded step is
  less well conditioned, within ``NOISE_FACTOR`` times the largest
  relative move of its own gradients when every weight is multiplied by
  1 + 2^-24 u (u standard normal: noise at f32's rounding).  The
  sharded sums run in another order, so bit for bit is not expected.
  The Qwen3 smoke's gradients move 1.8e-6 under that noise, so 1e-5
  holds; the Moonshot smoke's move 2.4e-4 and the Jamba smoke's 2.4e-3
  (16 layers, MoE every other one), and a sharded step moves them by as
  much, with every routing decision the same;
- with Adafactor (the Qwen3 case on (1, 4): its factored moments
  reduce over dims the mesh splits), each master weight's change over
  the step within ``F32_TOL`` of its largest value in the unsharded step
  plus 2 units in the last place of the weight (``_updates_check``);
- in bf16 (the step as it ships) the loss within ``BF16_TOL``, or
  within twice what bf16 alone moves the unsharded loss from the f32
  one, whichever is larger (the Jamba smoke's bf16 loss lies 0.04 from
  its f32 loss; the Qwen3 smoke's within 2e-4, so 1e-2 holds there);
- a served round (``ServeEngine(mesh=)``): every request's tokens equal
  to the unsharded engine's.  On the bf16 weights for the dense smoke
  configs; for the MoE ones (Moonshot, Jamba) on the f32 master
  weights, where bf16's rounding of each rank's partial sum (a
  contraction split across ranks is rounded to bf16 before the sum, the
  unsharded product once after it) flips near-tied tokens (on bf16
  weights half of Moonshot's tokens differed).  On the cards the
  matching bf16 tokens are counted, not gated, for the same reason.

The CPU cases: Qwen3 smoke on (2, 2) and (1, 4) meshes (on (1, 4) its 4
query heads over 2 kv heads that the axis does not divide: k and v
replicated, each rank's call slicing the kv head its query head reads),
the Moonshot smoke MoE on (2, 2) (training with as many token groups as
the "fsdp" axis, serving with fewer), and one period of the Jamba smoke
(8 layers: Mamba, attention at layer 4, MoE every other layer) on (2,
2).  On
the cards: Qwen3-1.7B on (2, 2) and (1, 4), B = 4 x 1,024, and each
rank's K7 / K7b launch counts in the sharded step (2 x 28 x
microbatches and 28 x microbatches: the forward and remat's recompute,
and the backward) and serving (28 a call).  Rank 0 prints one JSON line
and then ``MESH_CHECK_OK``; any failed check raises on its rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

RANKS = 4
MICRO = 2
F32_TOL = 1e-5
BF16_TOL = 1e-2
NOISE_FACTOR = 4

# (arch, mesh shape, batch, seq) per case; smoke configs on the CPU.  The
# MoE layers' two layouts: Moonshot trains B * S = 512 tokens in G = 2
# groups (as many as the "fsdp" axis) and serves 4 x 16 in G = 1 (fewer);
# Jamba trains 4 x 16 in G = 1
CPU_CASES = (("qwen3-1.7b", (2, 2), 4, 16),
             ("qwen3-1.7b", (1, 4), 4, 16, "adafactor"),
             ("moonshot-v1-16b-a3b", (2, 2), 8, 64),
             ("jamba-1.5-large-398b", (2, 2), 4, 16))
CUDA_CASES = (("qwen3-1.7b", (2, 2), 4, 1024),
              ("qwen3-1.7b", (1, 4), 4, 1024))


def _clone(tree):
    from repro_torch.common.pytree import tree_map

    return tree_map(lambda x: x.clone(), tree)


def _train(cfg, dev, mesh, batch, *, f32: bool, noise: bool = False):
    """One step from the seeded state (with ``noise``, each weight times
    1 + 2^-24 u, u standard normal), on ``mesh`` (None: unsharded) ->
    (loss, [(path, gradient before the clip)], [(path, (the step's change
    of the master weight, the weight's largest value after it))],
    launches)."""
    import torch

    from repro_torch.common.pytree import tree_leaves, tree_paths
    from repro_torch.dist.sharding import DEFAULT_RULES, mesh_context
    from repro_torch.kernels import _ext
    from repro_torch.launch.train import place_batch
    from repro_torch.train import step as step_mod

    settings = step_mod.TrainSettings(microbatches=MICRO, peak_lr=1e-3,
                                      warmup=1, total_steps=10)
    seen = []
    clip, cast = step_mod.clip_by_global_norm, step_mod.cast_for_compute

    def capture(grads, max_norm):
        # before the clip scales them in place (a replicated DTensor's
        # full_tensor() is its local tensor)
        seen.extend((g.full_tensor() if hasattr(g, "full_tensor")
                     else g).clone() for g in tree_leaves(grads))
        return clip(grads, max_norm)

    step_mod.clip_by_global_norm = capture
    if f32:
        step_mod.cast_for_compute = lambda p: p
    try:
        state = step_mod.init_train_state(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
        paths = tree_paths(state["params"])
        if noise:
            g = torch.Generator(dev).manual_seed(5)
            for x in tree_leaves(state["params"]):
                x.mul_(1 + 2.0 ** -24 * torch.randn(
                    x.shape, generator=g, device=dev, dtype=x.dtype))
        fn = step_mod.make_train_step(cfg, settings)
        before = [x.clone() for x in tree_leaves(state["params"])]
        _ext.reset_launches()
        if mesh is None:
            _, m = fn(state, batch)
        else:
            state = step_mod.place_train_state(state, cfg, mesh)
            with mesh_context(mesh, DEFAULT_RULES):
                _, m = fn(state, place_batch(batch, mesh))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(_ext.LAUNCHES)
        moved = []
        for x, b in zip(tree_leaves(state["params"]), before):
            x = x.full_tensor() if hasattr(x, "full_tensor") else x
            moved.append((x - b, float(x.abs().max())))
    finally:
        step_mod.clip_by_global_norm, step_mod.cast_for_compute = clip, cast
    return (float(m["loss"]), list(zip(paths, seen)),
            list(zip(paths, moved)), launches)


def _grads_check(name, plain, sharded, moved) -> dict:
    """Each sharded gradient within ``F32_TOL`` of the plain one's largest
    value, or, where the plain step is less well conditioned, within
    ``NOISE_FACTOR`` times its gradients' largest relative move under
    weight noise at f32's rounding (``moved()``: run only when a gradient
    is past ``F32_TOL``) -> the worst relative error, that move and the
    bound."""
    def rel(a, b):
        return float((a.to(b.device) - b).abs().max()
                     / b.abs().max().clamp_min(1e-30))

    errs = [(path, rel(g1, g0)) for (path, g0), (_, g1) in zip(plain,
                                                               sharded)]
    worst = max(e for _, e in errs)
    move, tol = None, F32_TOL
    if worst > F32_TOL and moved is not None:
        move = max(rel(m, g0) for (_, g0), (_, m) in zip(plain, moved()))
        tol = max(F32_TOL, NOISE_FACTOR * move)
    bad = [(path, e) for path, e in errs if e > tol]
    assert not bad, (name, bad[:4], move)
    return {"worst_rel": worst, "noise_move_rel": move, "tol": tol}


def _updates_check(name, plain, sharded) -> float:
    """Each master weight's change over the sharded step within
    ``F32_TOL`` of the unsharded change's largest value plus 2 units in
    the last place of the weight's largest value (the change is read as
    a difference of weights some 1e3 times larger, each rounded once) ->
    the worst error over its bound."""
    worst = 0.0
    for (path, (d0, pmax)), (_, (d1, _)) in zip(plain, sharded):
        bound = F32_TOL * float(d0.abs().max()) + 2 * 2.0 ** -23 * pmax
        err = float((d1.to(d0.device) - d0).abs().max())
        assert err <= bound, (name, path, err, bound)
        worst = max(worst, err / bound)
    return worst


def _serve(cfg, dev, mesh, params):
    """The launcher's requests through an unsharded engine and one on
    ``mesh`` -> (plain tokens, sharded tokens, launches of the sharded
    round, its prefill + decode calls)."""
    import torch

    from repro_torch.kernels import _ext
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine

    outs, launches, calls = [], None, 0
    for m in (None, mesh):
        reqs = make_requests(cfg, 4, 16, 6, 0)
        engine = ServeEngine(cfg, params, batch_slots=4, max_seq=64,
                             device=dev, mesh=m)
        for r in reqs:
            engine.submit(r)
        _ext.reset_launches()
        engine.run(max_steps=64)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(_ext.LAUNCHES)
        calls = engine.timing["prefill_calls"] + engine.timing["decode_calls"]
        outs.append([r.out for r in reqs])
        del engine
    return outs[0], outs[1], launches, calls


def _case(rank, dev, arch, shape, B, S, optimizer=None, *,
          full: bool) -> dict:
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import TokenDataset
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.train import cast_for_compute, init_train_state

    cfg = get_config(arch) if full else get_smoke_config(arch)
    if optimizer:
        cfg = dataclasses.replace(cfg, optimizer=optimizer)
    if cfg.family == "hybrid" and not full:
        # one period (Mamba, attention, MoE every other layer) of two
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_period)
    mesh = make_mesh_shape(shape, ("data", "model"), dev.type)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in TokenDataset(cfg.vocab_size, S, B,
                                      seed=1).batch_at(0).items()}
    name = f"{arch} {shape[0]}x{shape[1]} B={B} S={S} {cfg.optimizer}"
    rec = {"case": name}
    t = time.perf_counter()
    if not full:
        l0, plain, up0, _ = _train(cfg, dev, None, batch, f32=True)
        l1, sharded, up1, _ = _train(cfg, dev, mesh, batch, f32=True)
        assert abs(l1 - l0) <= F32_TOL * abs(l0), (name, l0, l1)
        rec.update(f32_loss=[l0, l1], f32_grads=_grads_check(
            name, plain, sharded, lambda: _train(cfg, dev, None, batch,
                                                 f32=True, noise=True)[1]))
        if cfg.optimizer == "adafactor":
            rec["f32_updates"] = _updates_check(name, up0, up1)
    l0 = _train(cfg, dev, None, batch, f32=False)[0]
    l1, _, _, launches = _train(cfg, dev, mesh, batch, f32=False)
    # bf16's roundings alone move the loss by |bf16 - f32|; a sharded
    # step rounds other partial sums, so it may move as far
    tol = BF16_TOL if full else max(BF16_TOL, 2 * abs(l0 - rec["f32_loss"][0]))
    assert abs(l1 - l0) <= tol, (name, "bf16", l0, l1, tol)
    rec.update(bf16_loss=[l0, l1], bf16_equal=l0 == l1, bf16_tol=tol)
    L = cfg.num_layers
    if dev.type == "cuda":
        want = {"flash_attention": 2 * L * MICRO,
                "flash_attention_bwd": L * MICRO}
        got = {k: v for k, v in launches.items() if v}
        assert got == want, (name, rank, got, want)
        rec["train_launches"] = got
    master = init_train_state(
        cfg, generator=torch.Generator(dev).manual_seed(0),
        device=dev)["params"]
    moe_cpu = bool(cfg.num_experts) and not full
    t0, t1, launches, calls = _serve(
        cfg, dev, mesh, master if moe_cpu else cast_for_compute(master))
    assert full or t0 == t1, (name, "served tokens", t0, t1)
    rec["served_tokens"] = sum(len(x) for x in t1)
    rec["tokens_equal"] = sum(a == b for x, y in zip(t0, t1)
                              for a, b in zip(x, y))
    rec["served_dtype"] = "float32" if moe_cpu else "bfloat16"
    if full:
        got = {k: v for k, v in launches.items() if v}
        assert got == {"flash_attention": L * calls}, (name, rank, got)
        rec["serve_launches"] = got
    rec["seconds"] = round(time.perf_counter() - t, 1)
    return rec


def _rank_main(rank: int, port: int, args) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.multihost import init_distributed

    os.environ.update(REPRO_NUM_PROC=str(RANKS), REPRO_PROC_ID=str(rank),
                      REPRO_COORD_ADDR=f"localhost:{port}")
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    init_distributed(device_type=dev.type)
    full = dev.type == "cuda"
    cases = CUDA_CASES if full else CPU_CASES
    try:
        recs = [_case(rank, dev, *c, full=full) for c in cases]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        out = {"ranks": RANKS, "backend": "nccl" if full else "gloo",
               "torch": torch.__version__, "cases": recs}
        if full:
            out["devices"] = [torch.cuda.get_device_name(i)
                              for i in range(RANKS)]
            out["total_memory"] = torch.cuda.get_device_properties(
                0).total_memory
        print(json.dumps(out), flush=True)
        print("MESH_CHECK_OK", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and torch.cuda.device_count() < RANKS:
        print(f"mesh_check: {RANKS} cards needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank_main, args=(port, args), nprocs=RANKS, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
