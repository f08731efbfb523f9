"""Multi-process bring-up (counterpart of ``repro.launch.multihost``):
the glue that turns the single-process code into a multi-node launch.

  * the data pipeline is stateless in (seed, host_id, step)
    (``data.tokens.TokenDataset``), so processes never exchange
    data-order state and a restart replays exactly;
  * checkpoints are integrity-checked and restore onto another device
    (``ckpt.checkpoint``).

``detect_cluster()`` reads the standard cluster environments:

  - manual:    REPRO_COORD_ADDR, REPRO_NUM_PROC, REPRO_PROC_ID
  - SLURM:     SLURM_PROCID / SLURM_NTASKS / SLURM_NODELIST
  - torchrun:  RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (in place of
               the reference's Cloud TPU autodetection)

and ``init_distributed()`` starts the default process group from it
(NCCL for CUDA, gloo for the CPU) when there is more than one process.
``host_batch_slice()`` maps the global batch to this process's rows, and
``make_global_batch()`` assembles the processes' rows into ``DTensor``s.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class HostInfo:
    process_id: int
    num_processes: int
    coordinator: str | None


def detect_cluster() -> HostInfo:
    env = os.environ
    if "REPRO_NUM_PROC" in env:
        return HostInfo(
            int(env.get("REPRO_PROC_ID", "0")),
            int(env["REPRO_NUM_PROC"]),
            env.get("REPRO_COORD_ADDR"),
        )
    if "SLURM_NTASKS" in env and int(env["SLURM_NTASKS"]) > 1:
        nodelist = env.get("SLURM_NODELIST", "localhost")
        head = nodelist.split(",")[0].split("[")[0]
        return HostInfo(
            int(env.get("SLURM_PROCID", "0")),
            int(env["SLURM_NTASKS"]),
            f"{head}:12345",
        )
    if "WORLD_SIZE" in env:
        addr = env.get("MASTER_ADDR")
        return HostInfo(
            int(env.get("RANK", "0")),
            int(env["WORLD_SIZE"]),
            None if addr is None else
            f"{addr}:{env.get('MASTER_PORT', '29500')}",
        )
    return HostInfo(0, 1, None)


def init_distributed(info: HostInfo | None = None,
                     device_type: str = "cuda") -> HostInfo:
    """Call once, before any collective, in every process: starts the
    default process group (NCCL for ``cuda``, gloo for ``cpu``) at the
    coordinator's address when there is more than one process."""
    info = info or detect_cluster()
    if info.num_processes > 1:
        import torch.distributed as dist

        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://{info.coordinator}",
            world_size=info.num_processes, rank=info.process_id)
    return info


def host_batch_slice(global_batch: int, info: HostInfo) -> slice:
    """Rows of the global batch this process materializes."""
    assert global_batch % info.num_processes == 0, (
        f"global batch {global_batch} must divide {info.num_processes} hosts"
    )
    per = global_batch // info.num_processes
    return slice(info.process_id * per, (info.process_id + 1) * per)


def make_global_batch(local_batch: dict, mesh, shardings) -> dict:
    """Per-process numpy arrays or tensors -> global ``DTensor``s on
    ``mesh``; ``shardings`` maps each key to its placements (as
    ``launch.mesh.sharding_tree`` gives them for the batch defs)."""
    import torch
    from torch.distributed.tensor import DTensor

    def one(x, place):
        t = torch.as_tensor(x, device=mesh.device_type)
        return DTensor.from_local(t, mesh, place)

    return {k: one(v, shardings[k]) for k, v in local_batch.items()}
