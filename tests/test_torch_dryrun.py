"""The dry-run tools (``repro_torch.launch.dryrun``, ``collectives``,
``step_cost``, ``roofline`` and ``core.autoshard``) against the
reference's: the roofline ``Cell`` on the same terms, the layout space,
the ring wire model against ``repro.launch.hlo.parse_collectives`` on
synthesised HLO lines, and the analytic state bytes of every arch and
shape on both production meshes.  In subprocesses (a process group, fake
or not, is process-wide state): a pure data-parallel layout's per-device
FLOPs against the one-rank tally, and the Qwen3 smoke prefill's
per-device FLOPs on a (2, 2) mesh against the reference's ``hlo_cost``
over its lowered step, term by term.

``repro.launch.dryrun`` is never imported here: it forces 512 XLA host
devices at import, and every later subprocess of this worker would
inherit them."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.common import pytree as jpt
from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.core.autoshard import layout_space as jlayout_space
from repro.launch import hlo as jhlo
from repro.launch import specs as jspecs
from repro.launch.roofline import Cell as JCell
from repro.launch.roofline import render_markdown as jrender
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.core.autoshard import layout_space
from repro_torch.launch import collectives
from repro_torch.launch.dryrun import analytic_hbm_bytes
from repro_torch.launch.roofline import Cell, render_markdown

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cells(terms, error=""):
    out = []
    for cls in (JCell, Cell):
        c = cls("a", "s", "pod", not error)
        if error:
            c.error = error
        else:
            (c.t_compute, c.t_memory, c.t_collective, c.model_flops,
             c.hlo_flops_total, c.peak_bytes) = terms
        out.append(c)
    return out


@pytest.mark.parametrize("terms", [
    (1.0, 2.0, 3.0, 1e15, 2e15, 2**30),
    (5.0, 2.0, 3.0, 1e15, 2e15, 3 * 2**30),
    (2.0, 1.0, 1.0, 1e15, 2e15, 2**30),
    (0.5, 4.0, 0.25, 3e14, 9e14, 7 * 2**29),
])
def test_cell_matches_reference(terms):
    ref, got = _cells(terms)
    for name in ("dominant", "t_bound", "useful_ratio", "roofline_fraction",
                 "t_model_compute"):
        assert getattr(got, name) == getattr(ref, name), name
    bad_ref, bad = _cells(None, error="boom")

    def table(md):
        # every column but the last (the note names each card's remedy)
        return [line.rsplit("|", 2)[0] for line in md.splitlines()]

    assert table(render_markdown([got, bad])) == table(jrender([ref,
                                                                bad_ref]))
    assert "FAILED" in render_markdown([bad]) and "boom" in render_markdown(
        [bad])


def test_layout_space_matches_reference():
    for chips in (256, 512, 4):
        ref, got = jlayout_space(chips), layout_space(chips)
        assert got.names == ref.names
        for a, b in zip(got.params, ref.params):
            assert (a.name, a.kind, tuple(a.values)) == (
                b.name, b.kind, tuple(b.values))


def _hlo_line(kind, dtype, dims, g):
    shape = f"{dtype}[{','.join(map(str, dims))}]{{1,0}}"
    if kind == "collective-permute":
        pairs = ",".join(f"{{{i},{(i + 1) % g}}}" for i in range(g))
        return (f"  %cp = {shape} collective-permute({shape} %p), "
                f"source_target_pairs={{{pairs}}}")
    return (f"  %x = {shape} {kind}({shape} %p), "
            f"replica_groups=[{16 // g},{g}]<=[16], dimensions={{0}}")


@pytest.mark.parametrize("g", (2, 4, 16))
@pytest.mark.parametrize("kind", collectives.KINDS)
@pytest.mark.parametrize("dtype", ("bf16", "f32"))
def test_ring_wire_model_matches_reference(kind, g, dtype):
    dims = (32, 128)
    (ref,) = jhlo.parse_collectives(_hlo_line(kind, dtype, dims, g), 16)
    got = collectives.collective(kind, dtype, ref.result_bytes,
                                 ref.group_size)
    assert ref.group_size == (2 if kind == "collective-permute" else g)
    assert got.wire_bytes == ref.wire_bytes
    # no XLA-CPU widening to undo: the bf16 figure is the lowered one
    assert got.wire_bytes_bf16 == got.wire_bytes
    summary = collectives.summarize_collectives([got, got])
    assert summary["by_kind"][kind]["count"] == 2
    assert summary["total"]["wire_bytes"] == 2 * ref.wire_bytes


class _Mesh:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("mesh", ({"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}))
def test_analytic_state_bytes_match_reference(mesh):
    n = 1
    for v in mesh.values():
        n *= v
    for arch in jlist_archs():
        for s in japplicable(jget_config(arch)):
            defs = jspecs.state_defs_for(jget_config(arch), JSHAPES[s])
            want = 0
            for tree in defs.values():
                want += (jpt.param_bytes(tree)
                         if not isinstance(tree, jpt.ParamDef)
                         else tree.size * np.dtype(tree.dtype).itemsize)
            got = analytic_hbm_bytes(get_config(arch), SHAPES[s],
                                     _Mesh(mesh))
            assert got == want / n, (arch, s)


def _run(code: str, env_extra=None, timeout=240) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


_PORT_TALLY = """
    import json
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import mesh_context
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.launch.step_cost import trace_step

    def tally(layout, kind, B, S, micro=None):
        cfg = get_smoke_config("qwen3-1.7b")
        shape = ShapeConfig("x", S, B, kind)
        dryrun.fake_world(layout[0] * layout[1])
        mesh = make_mesh_shape(layout, ("data", "model"), "cpu")
        rules = dryrun.pick_rules(cfg, shape)
        with mesh_context(mesh, rules):
            fn, args, _, _, _ = dryrun.build_step_and_specs(
                cfg, shape, mesh, rules=rules, microbatches=micro)
            cost = trace_step(fn, args, track=args)
        kern = sum(k[1] for k in cost.kernels.values())
        return {"flops": cost.flops, "kernel_flops": kern,
                "dots": cost.flops - kern, "peak": cost.peak,
                "by_kind": cost.report().coll_by_kind}
"""


def test_pure_data_parallel_flops_divide_by_world():
    """A (4, 1) layout (the batch over 4 ranks, nothing else split):
    rank 0's FLOPs are 1/4 of the one-rank tally of the same 2-microbatch
    train step, within 1 %."""
    rec = _run(_PORT_TALLY + """
    one = tally((1, 1), "train", 8, 32, micro=2)
    four = tally((4, 1), "train", 8, 32, micro=2)
    print(json.dumps({"one": one, "four": four}))
    """)
    one, four = rec["one"], rec["four"]
    assert one["flops"] > 0 and one["by_kind"] == {}
    assert abs(four["flops"] * 4 - one["flops"]) <= 0.01 * one["flops"]
    assert "all-gather" in four["by_kind"]


def test_prefill_flops_match_reference_hlo_cost():
    """Qwen3 smoke prefill (B = 4, S = 64) on a (2, 2) mesh: the
    reference's ``hlo_cost.analyze`` over its lowered, partitioned step
    against the port's tally on a fake 4-rank group, per device.  Term by
    term: the reference's attention is ``chunked_attention``, which forms
    the score of every query with every key of its 512-key chunks, the
    last padded, and masks it (4 B H S ceil(S / 512) 512 D FLOPs a
    layer, over the ranks its batch and heads split across); K7 counts
    the causal pairs it computes (4 B H D S (S + 1) / 2).  The rest, the products, agree
    within 5 %.  The collectives by kind are reported side by side and not
    gated: GSPMD and DTensor choose different ones."""
    B, S = 4, 64
    ref = _run(f"""
    import json, jax
    jax.devices()
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeConfig
    from repro.dist.sharding import mesh_context
    from repro.launch import hlo as hlo_mod, hlo_cost
    from repro.launch.dryrun import build_step_and_specs, pick_rules
    from repro.launch.mesh import make_mesh_shape
    cfg = get_smoke_config("qwen3-1.7b")
    shape = ShapeConfig("x", {S}, {B}, "prefill")
    mesh = make_mesh_shape((2, 2), ("data", "model"))
    rules = pick_rules(cfg, shape)
    with mesh, mesh_context(mesh, rules):
        fn, args, in_sh, out_sh, donate = build_step_and_specs(
            cfg, shape, mesh, rules=rules)
        txt = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                      donate_argnums=donate).lower(*args).compile().as_text()
    cost = hlo_cost.analyze(txt, 4)
    print(json.dumps({{"flops": cost.flops,
                       "by_kind": cost.coll_by_kind}}))
    """, env_extra={"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                    "JAX_PLATFORMS": "cpu"})
    got = _run(_PORT_TALLY + f"""
    print(json.dumps(tally((2, 2), "prefill", {B}, {S})))
    """)
    smoke = get_smoke_config("qwen3-1.7b")
    L, H, D = smoke.num_layers, smoke.num_heads, smoke.head_dim
    # the reference's scores and P V over every key of its padded chunks
    # (kv_chunk 512), its heads over the 2 "model" ranks and its batch
    # over the 2 "data" ranks
    skv = -(-S // 512) * 512
    ref_attn = L * 4.0 * B * H * S * skv * D / 4
    assert got["kernel_flops"] == L * 4.0 * B * H * D * (S * (S + 1) // 2) / 4
    rest_ref = ref["flops"] - ref_attn
    gap = abs(got["dots"] - rest_ref) / rest_ref
    print("reference", ref, "port", got, "products gap", gap)
    assert gap <= 0.05, (got["dots"], rest_ref, gap)
