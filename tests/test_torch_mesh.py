"""Sharded execution on 4 gloo ranks: ``tools/mesh_check.py --device
cpu`` in a subprocess, as ``test_torch_dist.py`` runs ``dist_check.py``.
Each rank trains one step of 2 microbatches and serves one round on a
("data", "model") mesh and unsharded, and holds the two together: the
Qwen3 smoke on (2, 2) and on (1, 4) (4 query heads over 2 kv heads the
axis does not divide), the Moonshot smoke MoE on (2, 2) (as many token
groups as the "fsdp" axis in training, fewer in serving), and one period
of the Jamba smoke on (2, 2) (fewer in training).  The tool's docstring states the bounds: the
f32 loss and gradients within 1e-5 where the unsharded step is well
conditioned (Qwen3), else within 4 times what noise at f32's rounding
moves the unsharded gradients; the bf16 loss within 1e-2 or twice its
own bf16 move; the served tokens equal."""

import json
import os
import subprocess
import sys


def test_sharded_steps_and_serving_on_four_gloo_ranks():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "tools", "mesh_check.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=repo, timeout=300)
    assert out.returncode == 0 and "MESH_CHECK_OK" in out.stdout, (
        out.stdout[-2000:], out.stderr[-4000:])
    rec = json.loads(out.stdout.splitlines()[-2])
    assert [c["case"].split()[0] for c in rec["cases"]] == [
        "qwen3-1.7b", "qwen3-1.7b", "moonshot-v1-16b-a3b",
        "jamba-1.5-large-398b"]
    for c in rec["cases"][:2]:
        assert c["f32_grads"]["tol"] == 1e-5 and c["bf16_tol"] == 1e-2


def test_launchers_run_on_a_fake_pod_and_multipod():
    """``--mesh pod`` / ``multipod`` under a world of 256 and 512 ranks:
    torch's fake process group in one process (rank 0; its collectives
    move nothing, so the values are not checked).  The smoke config
    trains 1 step on both production meshes and serves 2 requests on the
    pod's.  Serving on the 2 x 16 x 16 mesh runs too, but DTensor's
    redistribution planner takes over 2 minutes of this CPU's time to
    search the 3-D mesh's plans for the batch sharded over ("pod",
    "data"), so it is left out of the test."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json\n"
        "from repro_torch.launch import dryrun, serve, train\n"
        "out = {}\n"
        "for kind, world in (('pod', 256), ('multipod', 512)):\n"
        "    dryrun.fake_world(world)\n"
        "    t = train.main(['--device', 'cpu', '--mesh', kind, '--steps',"
        " '1', '--batch', '32', '--seq', '16'])\n"
        "    out[kind] = [t['steps']]\n"
        "    if kind == 'pod':\n"
        "        s = serve.main(['--device', 'cpu', '--mesh', kind,"
        " '--requests', '2', '--max-new', '2', '--slots', '32',"
        " '--max-seq', '32'])\n"
        "        out[kind] += [s['requests'], s['tokens']]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=repo, timeout=300)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-4000:])
    assert json.loads(res.stdout.splitlines()[-1]) == {
        "pod": [1, 2, 4], "multipod": [1]}
