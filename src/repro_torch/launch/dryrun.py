"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on
``meta`` tensors over a fake process group (counterpart of
``repro.launch.dryrun``).

The reference forces a 512-device CPU host and ``.lower().compile()``s
each cell's jitted step under its shardings.  The port starts a fake
process group of 256 or 512 ranks in this one process (torch's ``fake``
backend: collectives return outputs of the right shapes and move
nothing), builds the production mesh on it, places the step's inputs as
``meta`` ``DTensor``s by their defs' axes (``launch.specs``), and runs
the step eagerly under ``launch.step_cost.StepCost``: nothing is
allocated or computed, and the trace gives rank 0's per-device FLOPs,
bytes, collectives and peak memory.  Nothing here runs on a card.

Per cell this shows that the sharding is coherent (DTensor runs the
step on it), the per-device memory, and the roofline inputs.  The
record keeps the reference's keys: ``wall_lower_s`` is the time to
build the step and its placed inputs, ``wall_compile_s`` the trace's
wall time; ``memory_analysis`` is the trace's (``temp_bytes`` the peak
of live local storages past the arguments); ``cost_analysis`` and
``hlo_cost`` the ``StepCost`` totals; ``hlo_ops`` the aten op histogram
of the trace.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.common import pytree as pt
from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs
from repro_torch.dist.sharding import (
    DECODE_RULES,
    DEFAULT_RULES,
    PREFILL_RULES,
    mesh_context,
    mesh_shape,
)
from repro_torch.launch.collectives import op_histogram, summarize_collectives
from repro_torch.launch.mesh import make_production_mesh, sharding_tree
from repro_torch.launch.specs import state_defs_for
from repro_torch.launch.step_cost import trace_step
from repro_torch.models import registry
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.step import TrainSettings, make_train_step


def pick_rules(cfg, shape):
    """Decode rules (replicated activations, 2D-sharded weights) only pay
    when weights dwarf activations: >5B params.  Small models keep the
    batch-sharded default, as the reference picks them."""
    if shape.kind == "decode" and registry.param_count(cfg) > 5e9:
        return DECODE_RULES
    if shape.kind in ("prefill", "decode"):
        return PREFILL_RULES
    return DEFAULT_RULES


def pick_train_settings(cfg, shape, mesh) -> TrainSettings:
    """Microbatch count targeting ~1 sample/device/microbatch."""
    sizes = mesh_shape(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    micro = max(1, min(16, shape.global_batch // dp))
    while shape.global_batch % micro:
        micro -= 1
    return TrainSettings(microbatches=micro, remat=True)


def place_abstract(defs, mesh, rules):
    """A ParamDef tree -> ``meta`` ``DTensor``s placed as
    ``sharding_tree`` says, each holding rank 0's local shard shape."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    def one(d, place):
        local, _ = compute_local_shape_and_global_offset(d.shape, mesh,
                                                         place)
        x = torch.empty(local, dtype=d.dtype, device="meta")
        stride = torch.empty(d.shape, device="meta").stride()
        return DTensor.from_local(x, mesh, place, run_check=False,
                                  shape=torch.Size(d.shape), stride=stride)

    return pt.tree_map(one, defs, sharding_tree(defs, mesh, rules))


def build_step_and_specs(cfg, shape, mesh, *, microbatches=None, rules=None):
    """-> (fn, args, in_shardings, out_shardings, donate): the step, its
    inputs as placed ``meta`` DTensors, their placement trees, the
    outputs' (None: as the step leaves them) and the donated (updated in
    place) argument positions.  A decode traces the step at the cache's
    last position (``index = seq_len - 1``: every key attended)."""
    if rules is None:
        rules = pick_rules(cfg, shape)
    defs = state_defs_for(cfg, shape)
    sh = {k: sharding_tree(v, mesh, rules) for k, v in defs.items()
          if k != "index"}
    args = {k: place_abstract(v, mesh, rules) for k, v in defs.items()
            if k != "index"}
    if shape.kind == "train":
        settings = pick_train_settings(cfg, shape, mesh)
        if microbatches:
            micro = min(microbatches, shape.global_batch)
            while shape.global_batch % micro:
                micro -= 1
            settings = TrainSettings(microbatches=micro, remat=True)
        return (make_train_step(cfg, settings),
                (args["state"], args["batch"]),
                (sh["state"], sh["batch"]), None, (0,))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg), (args["params"], args["cache"],
                                         args["batch"]),
                (sh["params"], sh["cache"], sh["batch"]), None, (1,))
    raw = make_decode_step(cfg)

    def fn(params, cache, batch, index):
        return raw(params, cache, batch["tokens"], index)

    return (fn, (args["params"], args["cache"], args["batch"],
                 shape.seq_len - 1),
            (sh["params"], sh["cache"], sh["batch"], None), None, (1,))


def analytic_hbm_bytes(cfg, shape, mesh) -> float:
    """Cross-check: parameter+state bytes per device (excl. activations)."""
    defs = state_defs_for(cfg, shape)
    total = 0
    for tree in defs.values():
        total += pt.param_bytes(tree) if not isinstance(tree, pt.ParamDef) \
            else tree.size * tree.dtype.itemsize
    return total / math.prod(mesh_shape(mesh).values())


def fake_world(size: int) -> None:
    """Start (or restart at another size) a fake process group of
    ``size`` ranks in this process, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in pt.tree_leaves(tree) if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    fake_world(512 if mesh_kind == "multipod" else 256)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                device_type="cpu")
    sizes = mesh_shape(mesh)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": sizes, "kind": shape.kind,
        "devices": math.prod(sizes.values()), "ok": False,
    }
    t0 = time.perf_counter()
    rules = pick_rules(cfg, shape)
    try:
        with mesh_context(mesh, rules):
            fn, args, _, _, donate = build_step_and_specs(
                cfg, shape, mesh, rules=rules)
            t_lower = time.perf_counter() - t0
            cost = trace_step(fn, args, track=args)
            t_compile = time.perf_counter() - t0 - t_lower
        arg_bytes = _bytes(args)
        out_bytes = _bytes(cost.outputs)
        alias = sum(_bytes(args[i]) for i in donate)
        rep = cost.report()
        colls = summarize_collectives(cost.collectives)
        rec.update({
            "hlo_cost": rep.to_json(),
            "ok": True,
            "wall_lower_s": round(t_lower, 2),
            "wall_compile_s": round(t_compile, 2),
            "memory_analysis": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": cost.peak - arg_bytes,
                "alias_bytes": alias,
                "peak_bytes_est": cost.peak + out_bytes - alias,
            },
            "cost_analysis": {
                "flops": rep.flops,
                "transcendentals": cost.transcendentals,
                "bytes_accessed": rep.hbm_bytes,
            },
            "collectives": colls,
            "hlo_ops": op_histogram(cost.ops),
            "kernels": {k: dict(zip(("calls", "flops", "bytes"), v))
                        for k, v in cost.kernels.items()},
            "model_flops": registry.model_flops(cfg, shape),
            "params": registry.param_count(cfg),
            "active_params": registry.active_param_count(cfg),
            "analytic_state_bytes_per_dev": analytic_hbm_bytes(
                cfg, shape, mesh),
        })
    except Exception as e:  # noqa: BLE001 — a failed cell is a report, not a crash
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=6)
    rec["wall_total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for s in applicable_shapes(cfg):
            cells.append((arch, s))
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for arch, s in all_cells():
            print(f"{arch:28s} {s}")
        return

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    for mesh_kind in meshes:
        for arch, shape in cells:
            path = os.path.join(args.out, f"{mesh_kind}__{arch}__{shape}.json")
            if os.path.exists(path) and not args.force:
                with open(path) as f:
                    old = json.load(f)
                if old.get("ok"):
                    print(f"[skip] {mesh_kind} {arch} {shape} (cached ok)")
                    continue
            print(f"[run ] {mesh_kind} {arch} {shape} ...", flush=True)
            rec = run_cell(arch, shape, mesh_kind)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = "ok" if rec["ok"] else f"FAIL {rec.get('error', '')[:120]}"
            print(
                f"[done] {mesh_kind} {arch} {shape}: {status} "
                f"({rec['wall_total_s']}s)", flush=True,
            )


if __name__ == "__main__":
    main()
