#!/usr/bin/env python3
"""The collectives of ``repro_torch.dist`` over several ranks, one process
a rank: on the CPU over gloo (``tests/test_torch_dist.py`` runs it so),
or on the cards over NCCL, one card a rank.

    PYTHONPATH=src python tools/dist_check.py --device cpu      # 4 gloo ranks
    python3 tools/dist_check.py                                 # 4 cards, NCCL

Every rank checks, and rank 0 prints one JSON line and then
``DIST_CHECK_OK``:

- ``compressed_psum`` of each rank's seeded [8, 512] f32 tensor equal bit
  for bit to the rank-ordered sum of every rank's ``roundtrip`` on the
  same device, and within the reference test's relative 0.05 of
  ``all_reduce``; ``make_compressed_allreduce`` over a 1-D mesh the same;
- ``pipeline_apply`` (P = 4 stages, M = 8 microbatches of tanh(h @ W))
  within the reference test's 1e-5 of the sequential chain, the stage
  weights given whole and as a ``DTensor`` sharded over the stages;
  ``bubble_fraction(8, 4) == 3 / 11``;
- ``shard`` under a 2 x 2 ("data", "model") mesh: the local shard the
  spec says, ``full_tensor()`` the input, a ``redistribute`` and a shape
  the mesh does not divide;
- ``make_global_batch`` over the 1-D mesh: the processes' rows
  (``host_batch_slice``) make the global batch.

On the cards rank 0 also times ``all_reduce`` and ``compressed_psum`` of
``--elements`` f32 values (CUDA events, ``--iters`` calls after 3) and
prints ``wire_bytes`` beside them.  Needs 4 ranks (the 2 x 2 mesh).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

RANKS = 4


def _checks(rank: int, dev, args) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.compression import (
        compressed_psum,
        make_compressed_allreduce,
        roundtrip,
        wire_bytes,
    )
    from repro_torch.dist.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.dist.sharding import mesh_context, shard
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.launch.multihost import (
        detect_cluster,
        host_batch_slice,
        make_global_batch,
    )

    def t(a):
        return torch.as_tensor(a, device=dev)

    out = {}
    # compressed_psum: each rank's x, seeded by rank
    xs = [t(np.random.default_rng(r).normal(size=(8, 512)).astype(
        np.float32)) for r in range(RANKS)]
    want = roundtrip(xs[0])
    for x in xs[1:]:
        want = want + roundtrip(x)
    got = compressed_psum(xs[rank])
    assert torch.equal(got, want), float((got - want).abs().max())
    ref = xs[rank].clone()
    dist.all_reduce(ref)
    rel = float((ref - got).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 0.05, rel
    out["psum_rel_err"] = rel
    kind = dev.type
    line = make_mesh_shape((RANKS,), ("x",), kind)
    assert torch.equal(make_compressed_allreduce(line, "x")(xs[rank]), want)

    # pipeline_apply: P = 4 stages, M = 8 microbatches
    pipe = make_mesh_shape((RANKS,), ("pipe",), kind)
    rng = np.random.default_rng(0)
    Ws = t((rng.normal(size=(RANKS, 16, 16)) * 0.3).astype(np.float32))
    x = t(rng.normal(size=(8, 2, 16)).astype(np.float32))

    def stage(W, h):
        return torch.tanh(h @ W)

    piped = pipeline_apply(stage, Ws, x, mesh=pipe, axis="pipe")
    seq = x
    for s in range(RANKS):
        seq = torch.tanh(seq @ Ws[s])
    err = float((piped - seq).abs().max())
    assert torch.allclose(piped, seq, rtol=1e-5, atol=1e-5), err
    out["pipeline_max_err"] = err
    sharded = DTensor.from_local(Ws[rank:rank + 1], pipe, [Shard(0)])
    assert torch.equal(pipeline_apply(stage, sharded, x, mesh=pipe,
                                      axis="pipe"), piped)
    assert abs(bubble_fraction(8, 4) - 3 / 11) < 1e-12

    # shard on a 2 x 2 mesh
    mesh = make_mesh_shape((2, 2), ("data", "model"), kind)
    full = torch.arange(4 * 6, dtype=torch.float32, device=dev).reshape(4, 6)
    with mesh_context(mesh):
        dt = shard(full, "batch", "tp")
        i, j = rank // 2, rank % 2
        assert dt.placements == (Shard(0), Shard(1))
        assert torch.equal(dt.to_local(),
                           full[2 * i:2 * i + 2, 3 * j:3 * j + 3])
        assert torch.equal(dt.full_tensor(), full)
        re = shard(dt, None, "tp")
        assert re.placements == (Replicate(), Shard(1))
        assert torch.equal(re.to_local(), full[:, 3 * j:3 * j + 3])
        odd = shard(torch.ones(3, 5, device=dev), "batch", "tp")
        assert odd.placements == (Replicate(), Replicate())

    # make_global_batch: each process's rows of a global batch
    glob = torch.arange(8 * 3).reshape(8, 3)
    rows = glob[host_batch_slice(8, detect_cluster())]
    gb = make_global_batch({"tokens": rows.numpy()}, line,
                           {"tokens": [Shard(0)]})
    assert torch.equal(gb["tokens"].full_tensor().cpu(), glob)

    if kind == "cuda":
        n = args.elements
        g = torch.randn(n, generator=torch.Generator(dev).manual_seed(rank),
                        device=dev)
        for name, fn in (("all_reduce_ms", lambda: dist.all_reduce(
                g.clone())), ("compressed_psum_ms",
                              lambda: compressed_psum(g))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(args.iters):
                fn()
            b.record()
            torch.cuda.synchronize()
            out[name] = a.elapsed_time(b) / args.iters
        out["elements"] = n
        out["wire_bytes"] = wire_bytes(n, group=RANKS)
    return out


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
        dev = torch.device("cpu")
    info = init_distributed(device_type=dev.type)
    assert dist.get_world_size() == RANKS and info.process_id == rank
    try:
        out = _checks(rank, dev, args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        out.update(ranks=RANKS, backend="nccl" if dev.type == "cuda"
                   else "gloo", torch=torch.__version__)
        if dev.type == "cuda":
            out["devices"] = [torch.cuda.get_device_name(i)
                              for i in range(RANKS)]
        print(json.dumps(out), flush=True)
        print("DIST_CHECK_OK", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--elements", type=int, default=1 << 26)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and torch.cuda.device_count() < RANKS:
        print(f"dist_check: {RANKS} cards needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank_main, args=(port, args), nprocs=RANKS, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
