"""Homunculus's constrained BO driving the LM sharding search
(counterpart of ``repro.core.autoshard``).

The paper's loop is  suggest -> codegen -> compile -> feasibility verdict
-> update surrogate.  Here the "program" is a (mesh layout x microbatch x
remat x sharding-rule) configuration for one of the assigned
architectures, the "compiler in the loop" is the port's dry-run (the
step traced on ``meta`` tensors over a fake process group,
``launch.dryrun``), the feasibility constraint is fits-in-HBM (the
trace's peak of live local bytes within one card's memory), and the
objective is minimizing the dominant roofline term (``launch.step_cost``
at the rates of ``launch.roofline``).
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.bo import ConstrainedBO
from repro_torch.core.designspace import DesignSpace, Param
from repro_torch.dist.sharding import DEFAULT_RULES, AxisRules, mesh_context
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS

# one card's memory: torch.cuda.get_device_properties(0).total_memory on
# an NVIDIA H100 80GB HBM3 (power limit 700.00 W)
HBM_BYTES = 85_017_493_504


def layout_space(total_chips: int = 256) -> DesignSpace:
    """The sharding design space: (dp x tp) factorizations + step knobs."""
    factorizations = []
    d = 1
    while d <= total_chips:
        factorizations.append((d, total_chips // d))
        d *= 2
    return DesignSpace([
        Param("layout", "categorical", values=tuple(factorizations)),
        Param("microbatches", "ordinal", values=(1, 2, 4, 8, 16)),
        Param("remat", "categorical", values=("none", "dots", "block")),
        Param("seq_shard", "categorical", values=(False, True)),
    ])


@dataclasses.dataclass
class LayoutResult:
    config: dict
    feasible: bool
    peak_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    wall_s: float
    error: str = ""

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute, "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)


def evaluate_layout(
    arch: str,
    shape_name: str,
    config: dict,
    *,
    hbm_budget: float = HBM_BYTES,
) -> LayoutResult:
    """One black-box evaluation: trace the cell under ``config`` on the
    fake group of dp x tp ranks (one group of that size, reused across
    layouts)."""
    from repro_torch.launch.dryrun import build_step_and_specs, fake_world
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.launch.step_cost import trace_step

    t0 = time.perf_counter()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    dp, tp = config["layout"]
    cfg = dataclasses.replace(
        cfg,
        remat_policy=config.get("remat", cfg.remat_policy),
        decode_seq_shard=config.get("seq_shard", cfg.decode_seq_shard),
    )
    rules = DEFAULT_RULES
    if not config.get("seq_shard", True):
        rules = AxisRules({**DEFAULT_RULES.table})
        rules.table.pop("sp", None)
    fake_world(dp * tp)
    mesh = make_mesh_shape((dp, tp), ("data", "model"), "cpu")
    try:
        with mesh_context(mesh, rules):
            fn, args, _, _, _ = build_step_and_specs(
                cfg, shape, mesh,
                microbatches=config.get("microbatches"), rules=rules,
            )
            cost = trace_step(fn, args, track=args)
        rep = cost.report()
        return LayoutResult(
            config=config,
            feasible=cost.peak <= hbm_budget,
            peak_bytes=cost.peak,
            t_compute=rep.flops / PEAK_FLOPS,
            t_memory=rep.hbm_bytes / HBM_BW,
            t_collective=rep.coll_wire_bytes_bf16 / LINK_BW,
            wall_s=time.perf_counter() - t0,
        )
    except Exception as e:  # noqa: BLE001 — infeasible layout, not a crash
        return LayoutResult(
            config=config, feasible=False, peak_bytes=float("inf"),
            t_compute=0.0, t_memory=0.0, t_collective=float("inf"),
            wall_s=time.perf_counter() - t0, error=f"{type(e).__name__}: {e}",
        )


def autoshard(
    arch: str,
    shape_name: str,
    *,
    budget: int = 12,
    n_init: int = 4,
    total_chips: int = 256,
    hbm_budget: float = HBM_BYTES,
    seed: int = 0,
    callback=None,
) -> tuple[LayoutResult | None, list[LayoutResult]]:
    """BO over layouts; returns (best, all evaluated)."""
    space = layout_space(total_chips)
    bo = ConstrainedBO(space, n_init=n_init, seed=seed)
    evaluated: list[LayoutResult] = []

    def evaluate(config: dict) -> tuple[float, bool, dict]:
        res = evaluate_layout(arch, shape_name, config,
                              hbm_budget=hbm_budget)
        evaluated.append(res)
        if callback:
            callback(res)
        # maximize negative bound time (BO maximizes)
        value = -res.t_bound if res.feasible else float("nan")
        return value, res.feasible, {"result": res}

    best_obs = bo.run(evaluate, budget)
    best = best_obs.info["result"] if best_obs else None
    return best, evaluated


def main(argv=None) -> None:
    """``python -m repro_torch.core.autoshard --arch A --shape S
    [--budget N] [--out FILE]``: the BO's evaluations, one line each,
    then the best layout; ``--out`` writes them as JSON."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--budget", type=int, default=6)
    ap.add_argument("--n-init", type=int, default=4)
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def show(r: LayoutResult) -> None:
        print(f"{r.config} feasible={r.feasible} peak_GiB="
              f"{r.peak_bytes / 2**30:.2f} compute={r.t_compute:.4f} "
              f"memory={r.t_memory:.4f} collective={r.t_collective:.4f} "
              f"bound={r.t_bound:.4f} ({r.dominant}) {r.wall_s:.1f}s "
              f"{r.error[:100]}", flush=True)

    best, evaluated = autoshard(args.arch, args.shape, budget=args.budget,
                                n_init=args.n_init, total_chips=args.chips,
                                seed=args.seed, callback=show)
    print("best:", best.config if best else None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([dict(dataclasses.asdict(r), t_bound=r.t_bound,
                            dominant=r.dominant) for r in evaluated], f,
                      indent=1, default=str)


if __name__ == "__main__":
    main()
