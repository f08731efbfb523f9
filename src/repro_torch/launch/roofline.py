"""Roofline analysis over the dry-run's records (counterpart of
``repro.launch.roofline``), at one NVIDIA H100's rates.

Per (arch x shape x mesh) cell, from the dry-run JSON:

  compute term    = FLOPs_per_device / peak_FLOPs   (989 TFLOP/s bf16 dense)
  memory term     = bytes_per_device / HBM_bw       (3.35 TB/s)
  collective term = wire_bytes_per_device / link_bw (LINK_BW, measured)

FLOPs, bytes and wire bytes come from ``launch.step_cost``, rank 0's
local program of the step traced on ``meta`` tensors.  The peaks are
NVIDIA's data-sheet figures for the SXM part at 700 W.  The link rate
is not a data-sheet figure: it is what ``all_reduce`` of 2^26 f32 values
reached on 4 H100s over NVLink (``tools/dist_check.py``, 4 x NVIDIA H100
80GB HBM3 at 700.00 W): 402.65 MB of ring wire bytes a device in 1.371
ms.  A 256- or 512-card deployment spans hosts, whose links are slower,
so the collective term is a lower bound there.

Also reported per cell: the dominant term, MODEL_FLOPS = 6·N_active·D
(train) / 2·N_active·D (inference), the useful-compute ratio
traced/MODEL, and a one-line "what would move the dominant term" note.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

PEAK_FLOPS = 989e12     # bf16 dense / card (H100 SXM)
HBM_BW = 3.35e12        # B/s / card
LINK_BW = 402.65e6 / 1.371e-3   # B/s a device: all_reduce on 4 H100s


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    mesh: str
    ok: bool
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    model_flops: float = 0.0
    hlo_flops_total: float = 0.0
    peak_bytes: float = 0.0
    error: str = ""

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """Traced flops / MODEL flops (remat + attention overhead)."""
        return (self.hlo_flops_total / self.model_flops
                if self.model_flops else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound:
        MODEL_FLOPS / (chips * peak * t_bound)."""
        return self.t_model_compute / self.t_bound if self.t_bound else 0.0

    @property
    def t_model_compute(self) -> float:
        # time the *useful* model flops would take at peak
        return (self.model_flops / self.hlo_flops_total * self.t_compute
                if self.hlo_flops_total else 0.0)

    def note(self) -> str:
        if self.dominant == "compute":
            return ("compute-bound: reduce remat recompute "
                    f"(useful ratio {self.useful_ratio:.2f})")
        if self.dominant == "memory":
            return ("memory-bound: fuse the eager elementwise chains "
                    "(each op reads and writes HBM), cut f32 intermediates")
        return ("collective-bound: hoist weight all-gathers out of the "
                "microbatch loop, reshard to cut gather volume, overlap "
                "with compute")


def load_cell(path: str) -> Cell:
    with open(path) as f:
        r = json.load(f)
    cell = Cell(r["arch"], r["shape"], r["mesh"], r.get("ok", False))
    if not cell.ok:
        cell.error = r.get("error", "?")
        return cell
    hc = r["hlo_cost"]
    dev = r["devices"]
    cell.t_compute = hc["flops"] / PEAK_FLOPS
    cell.t_memory = hc["hbm_bytes"] / HBM_BW
    cell.t_collective = hc["coll_wire_bytes_bf16"] / LINK_BW
    cell.model_flops = r["model_flops"]
    cell.hlo_flops_total = hc["flops"] * dev
    cell.peak_bytes = r["memory_analysis"]["peak_bytes_est"]
    return cell


def load_all(dirpath: str, mesh: str | None = None) -> list[Cell]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        c = load_cell(path)
        if mesh is None or c.mesh == mesh:
            cells.append(c)
    return cells


def render_markdown(cells: list[Cell]) -> str:
    hdr = (
        "| arch | shape | mesh | compute s | memory s | collective s | "
        "dominant | HBM/dev GiB | HLO/MODEL | roofline frac | note |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for c in cells:
        if not c.ok:
            rows.append(
                f"| {c.arch} | {c.shape} | {c.mesh} | - | - | - | FAILED | - |"
                f" - | - | {c.error[:60]} |"
            )
            continue
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} "
            f"| {c.t_compute:.4f} | {c.t_memory:.4f} | {c.t_collective:.4f} "
            f"| **{c.dominant}** | {c.peak_bytes / 2**30:.2f} "
            f"| {c.useful_ratio:.2f} | {c.roofline_fraction:.3f} "
            f"| {c.note()} |"
        )
    return hdr + "\n".join(rows) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cells = load_all(args.dir, args.mesh)
    md = render_markdown(cells)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md)
    print(md)


if __name__ == "__main__":
    main()
