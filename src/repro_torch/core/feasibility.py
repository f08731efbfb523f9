"""Feasibility oracle + per-platform resource models (paper §3.2.2, §3.3;
counterpart of ``repro.core.feasibility``).

The Taurus, MAT and FPGA models and the flow-state and mitigation reports
are the JAX package's analytic models, copied (pure Python): the same
topology gets the same report in both.  The JAX package's TPU model
reads its Pallas kernels' VMEM sizes; here ``GPUModel`` takes its place
for this repository's GPU target, reading the port's own kernel envelope
(``kernels.fused_mlp``, ``kernels.flow_update``) and the H100's shared
memory per block.  Every figure of ``GPUModel`` names its source.

All shape/parameter accounting is read off the stage IR: a topology is
lowered to shape-only ``StageSpec``s (``core.stageir.lower_topology``).
The oracle stays a black box to the BO: config in, verdict out (§3.2.3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

# ------------------------------------------------------------------ report


@dataclasses.dataclass
class FeasibilityReport:
    feasible: bool
    reasons: list[str]                 # why infeasible (empty if feasible)
    resources: dict[str, float]        # platform-specific usage
    latency_ns: float
    throughput_pps: float              # packets/second the mapping sustains

    def merge(self, other: "FeasibilityReport") -> "FeasibilityReport":
        """Co-residency on one target: resources add, latency adds (chain),
        throughput is the min (paper §3.2.1 consistency rule)."""
        res = dict(self.resources)
        for k, v in other.resources.items():
            res[k] = res.get(k, 0) + v
        return FeasibilityReport(
            feasible=self.feasible and other.feasible,
            reasons=self.reasons + other.reasons,
            resources=res,
            latency_ns=self.latency_ns + other.latency_ns,
            throughput_pps=min(self.throughput_pps, other.throughput_pps),
        )


# ---------------------------------------------------------------- topology
#
# All shape/parameter accounting is read off the stage IR: a topology is
# lowered to shape-only StageSpecs (core.stageir.lower_topology) and every
# platform model below consumes stage metadata instead of re-deriving
# layer shapes per backend.


def _dense_specs(algorithm: str, topology: dict):
    from repro_torch.core.stageir import lower_topology

    return lower_topology(algorithm, topology, form="dense")


def _mat_specs(algorithm: str, topology: dict):
    from repro_torch.core.stageir import lower_topology

    return lower_topology(algorithm, topology, form="mat")


def dnn_layers(topology: dict) -> list[tuple[int, int]]:
    """(n_in, n_out) per dense layer, via the stage IR."""
    from repro_torch.core.stageir import spec_layers

    return spec_layers(_dense_specs("dnn", topology))


def topology_params(algorithm: str, topology: dict) -> int:
    from repro_torch.core.stageir import spec_params

    return spec_params(_dense_specs(algorithm, topology))


# ------------------------------------------------------------------ Taurus
#
# Plasticine-style grid of Compute Units (VEC-lane SIMD MAC pipes) and
# Memory Units (small SRAM banks).  Constants calibrated so the paper's
# Table-2 models land at the reported scale (203-param DNN ~ 24 CU / 48 MU).


@dataclasses.dataclass
class TaurusModel:
    rows: int = 16
    cols: int = 16
    vec: int = 8              # MAC lanes per CU
    mu_words: int = 6         # effective words per MU allocation unit
    clock_ghz: float = 1.0    # pipeline clock
    max_ii: int = 8           # max initiation interval the mapper will try

    @property
    def total_cu(self) -> int:
        return self.rows * self.cols

    @property
    def total_mu(self) -> int:
        return self.rows * self.cols

    def _layer_costs(self, layers: list[tuple[int, int]], ii: int):
        # NB: estimate_batch vectorizes these exact formulas — keep the two
        # in lockstep (tests/test_dse_parallel.py pins check == check_batch)
        cus = mus = 0
        stages = 0
        for n_in, n_out in layers:
            macs = n_in * n_out
            cus += max(1, math.ceil(macs / (self.vec * ii)))
            words = macs + n_out + 2 * n_out  # weights + bias + dbl-buffered act
            mus += max(1, math.ceil(words / self.mu_words))
            stages += 1 + math.ceil(math.log2(max(n_in, 2)))  # map + reduce tree
        return cus, mus, stages

    def estimate(self, algorithm: str, topology: dict) -> dict:
        """-> {cu, mu, latency_ns, throughput_pps(ii=1..), ii_options}."""
        from repro_torch.core.stageir import spec_layers

        specs = _dense_specs(algorithm, topology)
        if algorithm == "tree":
            # comparator chain: ~1 CU per 2 nodes, 1 MU per 4 nodes
            tree = specs[0]
            n = tree.params
            depth = tree.extra[0]
            return {
                "options": [{
                    "ii": 1,
                    "cu": max(1, n // 2),
                    "mu": max(1, n // 4),
                    "latency_ns": depth / self.clock_ghz,
                    "throughput_pps": self.clock_ghz * 1e9,
                }]
            }
        # every compute stage (dense layer / centroid table) maps to a
        # map x reduce-tree template occupying CUs at the chosen II
        layers = spec_layers(specs)

        options = []
        for ii in range(1, self.max_ii + 1):
            cu, mu, stages = self._layer_costs(layers, ii)
            options.append({
                "ii": ii,
                "cu": cu,
                "mu": mu,
                "latency_ns": stages / self.clock_ghz,
                "throughput_pps": self.clock_ghz * 1e9 / ii,
            })
        return {"options": options}

    def estimate_batch(self, algorithm: str, topologies: list[dict]
                       ) -> list[dict]:
        """``estimate`` for a whole candidate batch in one numpy pass.

        Every topology is lowered to stage specs once; the per-layer
        CU/MU/stage costs for ALL candidates and ALL initiation intervals
        are then computed on padded [B, L] arrays (padding masked out, so a
        phantom layer never charges the max(1, ...) floor).  Exactly
        equivalent to mapping ``estimate`` (tested), just without the
        per-candidate Python re-derivation.
        """
        from repro_torch.core.stageir import spec_layers

        if algorithm == "tree" or not topologies:
            return [self.estimate(algorithm, t) for t in topologies]
        import numpy as np

        layer_lists = [
            spec_layers(_dense_specs(algorithm, t)) for t in topologies
        ]
        B = len(layer_lists)
        L = max(len(ls) for ls in layer_lists)
        n_in = np.zeros((B, L), np.int64)
        n_out = np.zeros((B, L), np.int64)
        mask = np.zeros((B, L), bool)
        for b, ls in enumerate(layer_lists):
            for i, (fi, fo) in enumerate(ls):
                n_in[b, i], n_out[b, i], mask[b, i] = fi, fo, True
        macs = n_in * n_out
        words = macs + 3 * n_out          # weights + bias + dbl-buffered act
        stages = np.where(
            mask,
            1 + np.ceil(np.log2(np.maximum(n_in, 2))).astype(np.int64),
            0,
        ).sum(1)
        out: list[dict] = [{"options": []} for _ in range(B)]
        for ii in range(1, self.max_ii + 1):
            cus = np.where(
                mask, np.maximum(1, -(-macs // (self.vec * ii))), 0
            ).sum(1)
            mus = np.where(
                mask, np.maximum(1, -(-words // self.mu_words)), 0
            ).sum(1)
            for b in range(B):
                out[b]["options"].append({
                    "ii": ii,
                    "cu": int(cus[b]),
                    "mu": int(mus[b]),
                    "latency_ns": int(stages[b]) / self.clock_ghz,
                    "throughput_pps": self.clock_ghz * 1e9 / ii,
                })
        return out


# ----------------------------------------------------------------- MAT/PISA
#
# IIsy-style mapping rules (paper §4, §5.2.2):
#   KMeans:  one MAT per cluster
#   SVM:     one MAT per feature
#   Tree:    one MAT per tree level
#   LogReg:  one MAT per feature (per-feature LUT of partial scores)
#   DNN:     N2Net-style, ~12 MATs per layer [86]


@dataclasses.dataclass
class MATModel:
    num_tables: int = 12
    stage_ns: float = 25.0          # per-MAT pipeline latency
    line_rate_pps: float = 1e9      # Tofino line rate is fixed by the ASIC
    dnn_mats_per_layer: int = 12
    register_bytes: int = 4 * 2**20  # stateful register SRAM per pipeline

    def mats_for(self, algorithm: str, topology: dict) -> int:
        """Table count read off the MAT-form stage specs (IIsy rules)."""
        specs = _mat_specs(algorithm, topology)
        if algorithm == "kmeans":
            # one MAT per cluster: the LUT stage's output arity
            return next(s for s in specs if s.kind == "lut_gather").n_out
        if algorithm in ("svm", "logreg"):
            # one per-feature score table
            return next(s for s in specs if s.kind == "lut_gather").n_in
        if algorithm == "tree":
            # one MAT per tree level
            return specs[0].extra[0]
        if algorithm == "dnn":
            # N2Net-style folding: ~12 MATs per dense layer
            n_dense = sum(1 for s in specs if s.kind == "dense")
            return self.dnn_mats_per_layer * n_dense
        raise KeyError(algorithm)


# -------------------------------------------------------------------- FPGA
#
# P4-SDNet / Alveo U250-scale linear model: LUTs dominate (they hold model
# parameters [Table 5]), FFs pipeline them, BRAM holds feature buffers.


@dataclasses.dataclass
class FPGAModel:
    total_luts: int = 1_728_000     # Alveo U250
    total_ffs: int = 3_456_000
    total_bram: int = 2_688
    luts_per_param: float = 55.0    # calibrated to Table 5 deltas
    ffs_per_param: float = 25.0
    base_bram: int = 112            # loopback shell (4.15% of U250)
    clock_mhz: float = 322.0        # CMAC-domain clock

    def estimate(self, algorithm: str, topology: dict) -> dict:
        from repro_torch.core.stageir import spec_layers, spec_params

        specs = _dense_specs(algorithm, topology)
        params = spec_params(specs)
        depth = (
            len(spec_layers(specs)) * 6
            if algorithm in ("dnn", "logreg") else 8
        )
        return {
            "luts": int(params * self.luts_per_param),
            "ffs": int(params * self.ffs_per_param),
            "bram": self.base_bram,
            "latency_ns": depth * 1e3 / self.clock_mhz,
            "throughput_pps": self.clock_mhz * 1e6,  # 1 pkt/clk, line-limited
        }


# --------------------------------------------------------------------- GPU
#
# This repository's GPU target: an NVIDIA H100 serving a generated
# pipeline through the port's MLP kernels (K3/K5, kernels/fused_mlp).
# Feasibility = the kernels' envelope (layer widths and depth) and the
# block's shared memory; performance = one launch per batch of
# ``batch`` packets at the MLP kernel's measured MAC rate or the HBM
# rate, whichever is slower.


# shared memory one block may use on the H100: 227 KB (NVIDIA's H100
# documentation; RT_SMEM_MAX in kernels/csrc/mlp_argmax.cuh)
H100_SMEM_BYTES = 227 * 1024


def _mlp_hbuf_bytes() -> int:
    """Bytes of the MLP kernels' per-block activation rows (RT_WARPS warps
    x 2 rows x RT_MAX_MLP_WIDTH floats, kernels/csrc/mlp_argmax.cuh)."""
    from repro_torch.kernels import _ext

    return 4 * _ext.header_define("RT_WARPS") * 2 * \
        _ext.header_define("RT_MAX_MLP_WIDTH")


@dataclasses.dataclass
class GPUModel:
    smem_bytes: int = H100_SMEM_BYTES
    batch: int = 1024                   # serving batch per launch
    # device memory bytes/s: 3.35 TB/s (NVIDIA H100 SXM data sheet)
    hbm_bw: float = 3.35e12
    # device memory: 80 GB (NVIDIA H100 SXM data sheet)
    hbm_bytes: float = 80e9
    # host cost of one classifier launch: K3's wrapper, 0.0174 ms per call
    # at B = 512 (PERF.md §6 row 3; chip_smoke.py kernels_time, NVIDIA
    # H100 80GB HBM3, 700 W power limit)
    launch_us: float = 17.4
    # the MLP kernels' measured rate: K3 at [7, 128 x 10, 2] on 1,024 rows,
    # 152,174,592 MACs in 0.4530 ms of device time = 3.359e11 MAC/s
    # (PERF.md §6 row 3a; same run, card and limit)
    mac_per_s: float = 3.359e11

    def estimate(self, algorithm: str, topology: dict) -> dict:
        """-> {smem_bytes, staged, envelope, macs_per_pkt, latency_ns,
        throughput_pps}.  ``envelope`` is why the MLP kernels cannot take
        the model (None when they can)."""
        from repro_torch.core.stageir import spec_layers, spec_params
        from repro_torch.kernels.fused_mlp.ops import mlp_envelope_reason

        specs = _dense_specs(algorithm, topology)
        layers = spec_layers(specs)
        envelope = None
        if algorithm in ("dnn", "logreg", "svm"):
            envelope = mlp_envelope_reason(
                [n_in for n_in, _ in layers] + [layers[-1][1]])
        hbuf = _mlp_hbuf_bytes()
        weights = 4 * spec_params(specs)
        staged = weights + hbuf <= self.smem_bytes
        macs = sum(n_in * n_out for n_in, n_out in layers)
        n_in = layers[0][0] if layers else 0
        t_compute = self.batch * macs / self.mac_per_s
        t_mem = self.batch * 4 * (n_in + 1) / self.hbm_bw  # rows + verdicts
        t = self.launch_us * 1e-6 + max(t_compute, t_mem)
        return {
            "smem_bytes": hbuf + (weights if staged else 0),
            "staged": staged,
            "envelope": envelope,
            "macs_per_pkt": macs,
            "latency_ns": t * 1e9,
            "throughput_pps": self.batch / t,
        }


# -------------------------------------------------------------- flow state
#
# The per-flow register file (repro_torch.flowstate) is a CO-RESIDENT on
# the target: its slot/SRAM budget is charged like any other resource and
# composed with a model's report via FeasibilityReport.merge (the same
# §3.2.1 consistency rule multi-app chaining uses) — resources add,
# latency adds, throughput is the min.  The shape numbers are read off the
# shape-only stage specs (stageir.flowstate_specs), never re-derived here.


def flowstate_report(spec, platform_kind: str = "taurus", model: Any = None
                     ) -> FeasibilityReport:
    """Resource/latency report for one flow register file on one target.

    ``spec`` is a ``flowstate.FlowStateSpec``; ``model`` optionally
    overrides the platform resource model.  On the GPU the table must lie
    inside the register-update kernel's envelope (K2/K1:
    ``kernels.flow_update.envelope_reason``)."""
    from repro_torch.core.stageir import flowstate_specs, spec_params
    from repro_torch.kernels.flow_update.ops import envelope_reason

    words = spec_params(flowstate_specs(spec))
    return _register_table_report(
        words, platform_kind, model, what="flow registers",
        gpu_reason=envelope_reason(spec.n_slots, spec.width,
                                   len(spec.hist_sizes)),
    )


def mitigation_report(spec, platform_kind: str = "taurus", model: Any = None
                      ) -> FeasibilityReport:
    """Resource/latency report for one mitigation ACTION table — the
    per-flow drop/rate-limit registers a trailing ``Mitigate`` stage
    keeps (docs/pipeline_ir.md#mitigation-contract).

    ``spec`` is a ``flowstate.MitigationSpec``.  The action table is a
    second register file co-resident with the detection table, so it is
    charged through the SAME per-platform register model and composed via
    ``FeasibilityReport.merge`` — mitigation SRAM is never free.  On the
    GPU it lives in device memory beside the flow table and K1 folds its
    update into the fused launch."""
    from repro_torch.core.stageir import mitigation_specs, spec_params

    words = spec_params(mitigation_specs(spec))
    return _register_table_report(
        words, platform_kind, model, what="mitigation registers",
        gpu_reason=None,
    )


def _register_table_report(words: int, platform_kind: str, model: Any, *,
                           what: str, gpu_reason: str | None
                           ) -> FeasibilityReport:
    """Shared per-platform charging for one register table of ``words``
    32-bit words (stored keys included) — the flow-state detection table
    and the mitigation action table go through the same rules.
    ``gpu_reason``: why the GPU kernels cannot take the table, or None."""
    nbytes = words * 4
    reasons: list[str] = []

    if platform_kind == "taurus":
        m = model or TaurusModel()
        # register rows live in MU SRAM banks; hash + update occupy a
        # couple of CU ALU slots; one table read + write per packet
        mu = max(1, math.ceil(words / m.mu_words))
        cu = 2
        if mu > m.total_mu:
            reasons.append(
                f"{what} need {mu} MU > {m.total_mu} available"
            )
        return FeasibilityReport(
            feasible=not reasons, reasons=reasons,
            resources={"cu": cu, "mu": mu, "register_words": words},
            latency_ns=4 / m.clock_ghz,    # hash, read, update, write-back
            throughput_pps=m.clock_ghz * 1e9,
        )
    if platform_kind == "tofino":
        m = model or MATModel()
        if nbytes > m.register_bytes:
            reasons.append(
                f"{what} need {nbytes} B > {m.register_bytes} B "
                "register SRAM"
            )
        return FeasibilityReport(
            feasible=not reasons, reasons=reasons,
            resources={"mats": 1, "register_bytes": nbytes},
            latency_ns=2 * m.stage_ns,     # hash stage + register stage
            throughput_pps=m.line_rate_pps,
        )
    if platform_kind == "fpga":
        m = model or FPGAModel()
        bram = max(1, math.ceil(nbytes / 4608))   # 36Kb BRAM blocks
        if bram + m.base_bram > m.total_bram:
            reasons.append(
                f"{what} need {bram} BRAM > "
                f"{m.total_bram - m.base_bram} available"
            )
        return FeasibilityReport(
            feasible=not reasons, reasons=reasons,
            resources={"bram": bram, "register_bytes": nbytes},
            latency_ns=3 * 1e3 / m.clock_mhz,     # hash, read, write
            throughput_pps=m.clock_mhz * 1e6,
        )
    if platform_kind == "gpu":
        m = model or GPUModel()
        if gpu_reason is not None:
            reasons.append(f"{what}: {gpu_reason}")
        if nbytes > m.hbm_bytes:
            reasons.append(f"{what} need {nbytes} B > {m.hbm_bytes:.0f} B "
                           "device memory")
        launch = m.launch_us * 1e-6
        return FeasibilityReport(
            feasible=not reasons, reasons=reasons,
            resources={"hbm_bytes": nbytes, "register_words": words},
            latency_ns=launch * 1e9,
            throughput_pps=m.batch / launch,
        )
    raise KeyError(f"no flow-state model for platform {platform_kind!r}")
