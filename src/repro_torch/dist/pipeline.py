"""Pipeline parallelism: the GPipe schedule over one mesh dim
(counterpart of ``repro.dist.pipeline``).

Each rank of the dim holds one stage's weights; microbatches stream
through the stages, and each tick hands every rank's activation to the
next rank (``batch_isend_irecv``, the reference's collective-permute).
With M microbatches and P stages the schedule runs M+P-1 ticks, so the
bubble (idle) fraction is (P-1)/(M+P-1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def bubble_fraction(microbatches: int, stages: int) -> float:
    """Idle fraction of the GPipe schedule: (P-1)/(M+P-1)."""
    return (stages - 1) / (microbatches + stages - 1)


def pipeline_apply(stage_fn, stage_params: torch.Tensor, x: torch.Tensor, *,
                   mesh, axis: str) -> torch.Tensor:
    """Run x through P stages, stage p on rank p of ``mesh``'s dim
    ``axis``.

    stage_fn: (W, h) -> h' applied per microbatch.
    stage_params: this rank's stage weights: a ``DTensor`` sharded on dim
        0 over ``axis`` ([P, ...] globally, [1, ...] here), or a plain
        [P, ...] tensor of which this rank takes row p.
    x: [M, microbatch, ...] microbatches, the same on every rank.
    Returns [M, microbatch, ...] after all P stages, on every rank.
    """
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    p = mesh.get_local_rank(axis)
    w = (stage_params.to_local()[0] if isinstance(stage_params, DTensor)
         else stage_params[p])
    n_micro = x.shape[0]
    nxt = dist.get_global_rank(group, (p + 1) % n_stages)
    prv = dist.get_global_rank(group, (p - 1) % n_stages)
    recv = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t; later stages consume the
        # activation handed in from stage p-1 at tick t-1
        h_in = x[min(t, n_micro - 1)] if p == 0 else recv
        h_out = stage_fn(w, h_in).contiguous()
        o_idx = t - (n_stages - 1)
        if p == n_stages - 1 and o_idx >= 0:
            outs[o_idx] = h_out
        recv = torch.empty_like(h_out)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, h_out, nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)]):
            req.wait()
    # only the last stage holds real outputs (the others keep zeros): a
    # sum over the dim gives every rank the result
    dist.all_reduce(outs, group=group)
    return outs
