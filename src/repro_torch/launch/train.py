"""Training launcher: the fault-tolerant loop over the token pipeline
(counterpart of ``repro.launch.train``).

Runs on the card unless ``--device cpu`` is given (the plain versions of
the kernels run there); the smoke configs by default, the published one
with ``--full``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

``--mesh pod`` / ``multipod`` raise: the reference's models annotate
their activations with ``dist.sharding.shard`` and the port's do not yet,
so a sharded run waits for those annotations rather than running
unsharded under a mesh's name.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import TokenDataset
from repro_torch.device import resolve_device
from repro_torch.ft.restart import RestartManager
from repro_torch.train.step import (
    TrainSettings,
    init_train_state,
    make_train_step,
)

MESH_REASON = (
    "--mesh {mesh}: the port's models do not yet carry the reference's "
    "dist.sharding.shard annotations (repro/models/layers.py:111-143, "
    "moe.py:50-100, train/step.py:93-98), so a sharded run waits for them; "
    "run with --mesh none")


def check_mesh(mesh: str) -> None:
    """Raises for a mesh other than ``none``, naming the reason."""
    if mesh != "none":
        raise NotImplementedError(MESH_REASON.format(mesh=mesh))


def main(argv=None, *, state=None, on_step=None) -> dict:
    """Parse ``argv`` and train.  ``state``: a train state to start from
    (on the device) in place of the seeded one; ``on_step(step,
    metrics)``: called after each step, beside the log line."""
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
    check_mesh(args.mesh)
    dev = resolve_device(args.device)
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
        return b

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
    step_fn = make_train_step(cfg, settings)

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
    wall = time.perf_counter() - t0

    out = {
        "arch": cfg.name,
        "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "wall_s": round(wall, 1),
    }
    print(out)
    return out


if __name__ == "__main__":
    main()
