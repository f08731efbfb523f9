"""Training launcher: the fault-tolerant loop over the token pipeline
(counterpart of ``repro.launch.train``).

Runs on the card unless ``--device cpu`` is given (the plain versions of
the kernels run there); the smoke configs by default, the published one
with ``--full``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

``--mesh pod`` / ``multipod`` build the production mesh (16 x 16 or 2 x
16 x 16) over the default process group, whose world must be 256 or 512
ranks (``launch.mesh`` raises otherwise), and train under
``mesh_context(mesh, DEFAULT_RULES)`` with the state placed by its defs'
axes (``train.step.place_train_state``) and each batch by ("batch",
None); not with ``--ckpt-dir``.  ``main(mesh=...)`` takes a
``DeviceMesh`` of any shape in its place.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from repro_torch.common.pytree import ParamDef
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import TokenDataset
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import DEFAULT_RULES, mesh_context
from repro_torch.ft.restart import RestartManager
from repro_torch.launch.mesh import make_production_mesh, place_tree
from repro_torch.train.step import (
    TrainSettings,
    init_train_state,
    make_train_step,
    place_train_state,
)

def launch_mesh(kind: str, mesh, device: torch.device):
    """``--mesh``'s ``kind`` -> the mesh to run on: ``mesh`` when one is
    given, the production mesh for pod / multipod, None for none."""
    if mesh is not None or kind == "none":
        return mesh
    return make_production_mesh(multi_pod=kind == "multipod",
                                device_type=device.type)


def place_batch(batch: dict, mesh, rules=DEFAULT_RULES) -> dict:
    """A batch (the same full value on every rank) -> ``DTensor``s with
    the rows over "batch" (``registry``'s batch defs' axes)."""
    defs = {k: ParamDef(tuple(v.shape), v.dtype,
                        ("batch",) + (None,) * (v.dim() - 1))
            for k, v in batch.items()}
    return place_tree(batch, defs, mesh, rules)


def main(argv=None, *, state=None, on_step=None, mesh=None) -> dict:
    """Parse ``argv`` and train.  ``state``: a train state to start from
    (on the device, unplaced) in place of the seeded one; ``on_step(step,
    metrics)``: called after each step, beside the log line; ``mesh``: a
    ``DeviceMesh`` to train on in place of ``--mesh``'s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "pod", "multipod"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    settings = TrainSettings(
        microbatches=args.microbatches, peak_lr=args.lr,
        warmup=max(5, args.steps // 10), total_steps=args.steps,
        remat=True,
    )
    dev = resolve_device(args.device)
    mesh = launch_mesh(args.mesh, mesh, dev)
    if mesh is not None and args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir with a mesh: the checkpoint writes each leaf whole "
            "from one process, and a sharded state's leaves are DTensors "
            "whose shards lie on every rank; train sharded without it")
    data = TokenDataset(cfg.vocab_size, args.seq, args.batch, seed=args.seed)

    def batch_fn(step: int):
        # zero frames / image embeddings in f32, as the reference's
        # launcher makes them (the forward casts them)
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch_at(step).items()}
        if cfg.family == "encdec":
            b["frames"] = torch.zeros((args.batch, args.seq, cfg.d_model),
                                      dtype=torch.float32, device=dev)
        if cfg.family == "vlm":
            b["image_embeds"] = torch.zeros(
                (args.batch, cfg.num_image_tokens, cfg.d_model),
                dtype=torch.float32, device=dev)
        return b if mesh is None else place_batch(b, mesh)

    losses = []

    def metrics_cb(step, metrics, dt):
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, metrics)
        if step % args.log_every == 0 or step == args.steps:
            print(
                f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
                f"acc {float(metrics['accuracy']):.3f}  "
                f"gnorm {float(metrics['grad_norm']):.2f}  {dt * 1e3:.0f} ms",
                flush=True,
            )

    if state is None:
        state = init_train_state(
            cfg, generator=torch.Generator(dev).manual_seed(args.seed),
            device=dev)
    if mesh is not None:
        state = place_train_state(state, cfg, mesh)
    step_fn = make_train_step(cfg, settings)
    ctx = (contextlib.nullcontext() if mesh is None
           else mesh_context(mesh, DEFAULT_RULES))
    with ctx:
        state, losses, wall = _loop(args, state, step_fn, batch_fn,
                                    metrics_cb, losses)
    out = {
        "arch": cfg.name,
        "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "wall_s": round(wall, 1),
    }
    print(out)
    return out


def _loop(args, state, step_fn, batch_fn, metrics_cb, losses):
    t0 = time.perf_counter()
    if args.ckpt_dir:
        mgr = RestartManager(args.ckpt_dir, save_every=args.save_every)
        state, start = mgr.maybe_restore(state)
        if start:
            print(f"resumed from checkpoint at step {start}")
        state, step = mgr.run(
            state, step_fn, batch_fn,
            num_steps=args.steps, start_step=start,
            metrics_cb=metrics_cb,
        )
    else:
        for step in range(args.steps):
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(step))
            metrics_cb(step + 1, metrics, time.perf_counter() - t1)
    return state, losses, time.perf_counter() - t0


if __name__ == "__main__":
    main()
