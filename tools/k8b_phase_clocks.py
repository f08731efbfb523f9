#!/usr/bin/env python3
"""Where a chunk of K8b's walk (``selective_scan_bwd_kernel``) spends its
cycles, and what the build gives each instance.

    python3 tools/k8b_phase_clocks.py [--root CHECKOUT] [case ...]
        (default: every case of ``chip_smoke.K8B_CASES``)

Builds CHECKOUT's ``selective_scan_bwd.cu`` (default: this one) twice with
``nvcc`` beside a small C entry point into ``build/k8b_*.so`` (no PyTorch
headers):

* as it is, with ``-Xptxas -v``: prints each ``selective_scan_bwd_kernel``
  instance's registers and spill bytes and, from ``cuobjdump -sass``, its
  static SASS instruction count (``tools/sass_count.py``'s reading);
* with ``clock64()`` read by thread 0 of each block at the phase
  boundaries of a chunk (``DESIGNS`` below: the kernel's text decides
  which boundaries): prints the mean cycles of each phase a chunk and a
  step, as thread 0 of warp 0 sees them.  The clock reads order the code
  around them, so the phases sum to a little more than an uninstrumented
  chunk.

Then, for each case, the uninstrumented kernel's time (CUDA events over
10 calls; its checkpoints from ``scan_checkpoints`` at CHECKOUT's chunk).
Two checkouts time against each other on one card by running the tool
once on each in one command.  Needs a card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
REL = "src/repro_torch/kernels/selective_scan/csrc/selective_scan_bwd.cu"
INC = "src/repro_torch/kernels/csrc"
OUT = os.path.join(ROOT, "build")
NVCC = "/usr/local/cuda/bin/nvcc"

ENTRY = r'''
extern "C" int k8b_bwd(const float* dt, const float* A, const float* Bm,
                       const float* C, const void* x, const float* ckpt,
                       const float* dy, const float* dh_final, float* ddt,
                       float* dA, float* dBm, float* dC, void* dx,
                       float* dh0, float* ws_b, float* ws_c, float* ws_a,
                       int B, int S, int di, int N, int x_bf16,
                       void* stream) {
  ScanBwdArgs a{};
  a.dt = dt; a.A = A; a.Bm = Bm; a.C = C; a.x = x; a.ckpt = ckpt;
  a.dy = dy; a.dh_final = dh_final; a.ddt = ddt; a.dA = dA; a.dBm = dBm;
  a.dC = dC; a.dx = dx; a.dh0 = dh0; a.ws_b = ws_b; a.ws_c = ws_c;
  a.ws_a = ws_a; a.B = B; a.S = S; a.di = di; a.N = N;
  return (int)launch_selective_scan_bwd(a, x_bf16, (cudaStream_t)stream);
}
'''

CLOCK_ENTRY = r'''
extern "C" int k8b_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_clk,
                                   sizeof(unsigned long long) * 16);
}
'''

# One entry a design of the kernel: (text that only its source holds,
# chunk loop head, [(text, slot, "before" | "after")]: slot i's phase
# ends there, searched in order from the loop head, the text before the
# chunk loop's closing brace (the last phase ends there), phase names).
DESIGNS = (
    ("first: one thread a channel, h_{t-1} in shared memory",
     "hist[(u * N + n) * SSB_THREADS + tid] = h[n];",
     "  for (int c = nC - 1; c >= 0; --c) {\n", [
         ("    // the chunk forward from its checkpoint", 0, "before"),
         ("        const float s = warp_sum_scatter<N>(v, lane);\n"
          "        if (writer) red_c", 1, "before"),
         ("if (writer) red_c[(u * W + warp) * N + my_n] = s;\n", 2,
          "after"),
         ("        const float s = warp_sum_scatter<N>(v, lane);\n"
          "        if (writer) red_b", 3, "before"),
         ("if (writer) red_b[(u * W + warp) * N + my_n] = s;\n", 4,
          "after"),
         ("    __syncthreads();\n\n    // the block's partials", 5,
          "before"),
     ], "  }\n  if (live) {\n    stg_row<N>(p.ws_a",
     ("loads and barriers", "recompute", "butterfly (dC)", "walk",
      "butterfly (dBm)", "ddt and dx stores",
      "barrier and partials' write")),
    ("current: a channel's states over lanes, dA and dA h in the history",
     "const float s = chan_sum<NL, L>(v",
     "  for (int c = nC - 1; c >= 0; --c) {\n", [
         ("    // the chunk forward from its checkpoint", 0, "before"),
         ("        const float s = chan_sum<NL, L>(v", 1, "before"),
         ("if (writer) *pr = s;\n", 2, "after"),
         ("        // the sums over n", 3, "before"),
         ("        const float s = chan_sum<NL, L>(v", 4, "before"),
         ("if (writer) *pr = s;\n", 5, "after"),
         ("    // the block's partials of the chunk's dBm and dC", 6,
          "before"),
     ], "  }\n  if (live) {\n    st",
     ("chunk start", "recompute", "butterfly (dC)", "walk",
      "sums over n, ddt and dx stores", "butterfly (dBm)", "barrier",
      "partials, next stage, barrier")),
)


def header(root: str, sets: dict) -> str:
    """``root``'s rt_types.h with the integer defines in ``sets``
    replaced."""
    with open(os.path.join(root, INC, "rt_types.h")) as f:
        text = f.read()
    for name, value in sets.items():
        text, n = re.subn(rf"#define {name} \d+", f"#define {name} {value}",
                          text)
        if n != 1:
            raise SystemExit(f"rt_types.h has no integer #define {name}")
    return text


def chunk_of(text: str, N: int) -> int:
    """SSB_CHUNK(N) as the header ``text`` defines it."""
    val = {k: int(v) for k, v in re.findall(
        r"#define (SSB_HIST|SSB_MAX_T) (\d+)", text)}
    return min(val["SSB_MAX_T"], max(1, val["SSB_HIST"] // N))


def design_of(src: str):
    for d in DESIGNS:
        if d[1] in src:
            return d
    raise SystemExit("no DESIGNS entry matches this selective_scan_bwd.cu")


def instrument(src: str) -> str:
    _, _, head, marks, end, _ = design_of(src)
    src = src.replace("namespace {\n", (
        "__device__ unsigned long long g_clk[16];\n"
        "#define PT(i) do { unsigned long long _n = clock64(); "
        "pc[i] += _n - _t; _t = _n; } while (0)\n") + "namespace {\n", 1)
    pos = src.index(head)
    src = (src[:pos] + "  unsigned long long pc[8] = {0}, n_chunks = 0;\n"
           + src[pos:])
    pos = src.index(head, pos) + len(head)
    src = src[:pos] + "    unsigned long long _t = clock64(); ++n_chunks;\n" \
        + src[pos:]
    for text, slot, where in marks:
        j = src.index(text, pos)
        ins = f"PT({slot});\n"
        if where == "after":
            j += len(text)
        src = src[:j] + ins + src[j:]
        pos = j + len(ins)
    j = src.index(end, pos)
    last = len(marks)
    src = src[:j] + f"PT({last});\n" + src[j:]
    j = src.index("  }\n", j + len(f"PT({last});\n")) + len("  }\n")
    src = (src[:j] + "  if (threadIdx.x == 0) { for (int u = 0; u < 8; ++u)"
           " atomicAdd(&g_clk[u], pc[u]); atomicAdd(&g_clk[8], n_chunks); "
           "atomicAdd(&g_clk[9], 1ull); }\n" + src[j:])
    return src


def build(root: str, inc: str, tag: str, clocks: bool) -> tuple[list, str]:
    """Writes the source to build/ -> (nvcc's command, the .so's path)."""
    with open(os.path.join(root, REL)) as f:
        src = f.read()
    cu = os.path.join(OUT, f"k8b_{tag}.cu")
    so = os.path.join(OUT, f"k8b_{tag}.so")
    with open(cu, "w") as f:
        f.write(instrument(src) + CLOCK_ENTRY + ENTRY if clocks
                else src + ENTRY)
    cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", inc, "-I",
           os.path.join(root, INC), "-o", so, cu]
    if not clocks:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd, so


def ptxas_report(text: str) -> dict:
    """{instance: {"registers", "spill_stores", "spill_loads"}} for each
    selective_scan_bwd_kernel instance in ``-Xptxas -v``'s report."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            fn = m.group(1)
            continue
        if not fn or "selective_scan_bwd_kernel" not in fn:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(instance(fn), {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(instance(fn), {})["registers"] = int(m.group(1))
    return out


def instance(mangled: str) -> str:
    m = re.search(r"selective_scan_bwd_kernelILi(\d+)ELb([01])E", mangled)
    return (f"selective_scan_bwd_kernel<{m.group(1)}, "
            f"{'true' if m.group(2) == '1' else 'false'}>" if m else mangled)


def loops(sass: str) -> dict:
    """{mangled name: [instructions of each loop body]}: every backward
    branch of the function (``BRA`` to a lower address) and the
    instructions from its target to it, NOP excluded."""
    out, name, addrs = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, addrs = m.group(1), []
            out[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if not (name and m) or m.group(2) == "NOP":
            continue
        at = int(m.group(1), 16)
        addrs.append(at)
        t = re.search(r"`?\(?\.?L?_?x?_?(?:0x)?([0-9a-f]+)\)?\s*;",
                      m.group(3)) if m.group(2).startswith("BRA") else None
        if t and int(t.group(1), 16) < at:
            lo = int(t.group(1), 16)
            out[name].append(sum(1 for a in addrs if lo <= a <= at))
    return out


def sass_counts(so: str) -> dict:
    from tools.sass_count import functions

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    bodies = loops(sass)
    return {instance(name): {"instructions": len(ops), "top": dict(
        collections.Counter(ops).most_common(8)),
        "loop_bodies": bodies.get(name, [])}
        for name, ops in functions(sass).items()
        if "selective_scan_bwd_kernel" in name}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="build with an integer #define of rt_types.h "
                         "replaced (SSB_HIST=64: a chunk half as long)")
    ap.add_argument("cases", nargs="*")
    args = ap.parse_args()
    sets = dict(kv.split("=") for kv in args.set)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.selective_scan import scan_checkpoints

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    root = os.path.abspath(args.root)
    tag = re.sub(r"\W", "_", ("this" if root == ROOT else os.path.relpath(
        root, ROOT)) + "".join(f"_{k}{v}" for k, v in sets.items()))
    with open(os.path.join(root, REL)) as f:
        design = design_of(f.read())
    hdr = header(root, sets)
    inc = os.path.join(OUT, f"k8b_inc_{tag}")
    os.makedirs(inc, exist_ok=True)
    with open(os.path.join(inc, "rt_types.h"), "w") as f:
        f.write(hdr)
    jobs = [build(root, inc, tag + "_plain", False),
            build(root, inc, tag + "_clk", True)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, _ in jobs]
    logs = [p.communicate()[0] for p in procs]
    for p, log in zip(procs, logs):
        if p.returncode:
            print(log[-4000:], file=sys.stderr)
            return 1
    print(json.dumps({"root": os.path.relpath(root, ROOT), "set": sets,
                      "design": design[0], "nvidia_smi": cs.nvidia_smi(),
                      "ptxas": ptxas_report(logs[0]),
                      "sass": sass_counts(jobs[0][1])}), flush=True)
    libs = []
    for _, so in jobs:
        lib = ctypes.CDLL(so)
        lib.k8b_bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        libs.append(lib)
    libs[1].k8b_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda", 0)
    cases = {c[0]: c for c in cs.K8B_CASES}
    for name in args.cases or list(cases):
        _, B, S, di, N, xdt, h0k, dhk = cases[name]
        dt, A, Bm, Cm, x, h0, dy, dh = cs.k8b_inputs(dev, B, S, di, N, xdt,
                                                     h0k, dhk, 500)
        T = chunk_of(hdr, N)
        ckpt = scan_checkpoints(dt, A, Bm, x, h0, T)
        f32 = dict(dtype=torch.float32, device=dev)
        outs = [torch.empty_like(dt), torch.empty_like(A),
                torch.empty_like(Bm), torch.empty_like(Cm),
                torch.empty_like(x), torch.empty((B, di, N), **f32)]
        ws = [torch.empty(-(-di // 16) * B * S * N, **f32) for _ in (0, 1)]
        ws.append(torch.empty(B * di * N, **f32))
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

        def run(lib):
            rc = lib.k8b_bwd(*map(ptr, (dt, A, Bm, Cm, x, ckpt, dy, dh,
                                        *outs, *ws)),
                             B, S, di, N, int(xdt == "bfloat16"),
                             torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        libs[1].k8b_clocks(None, 1)
        run(libs[1])
        torch.cuda.synchronize()
        clk = (ctypes.c_ulonglong * 16)()
        libs[1].k8b_clocks(ctypes.cast(clk, ctypes.c_void_p), 0)
        chunks = max(clk[8], 1)
        phases = {n: round(clk[i] / chunks) for i, n in enumerate(design[5])}
        ms = cs.time_ms(lambda: run(libs[0]), 10)
        print(json.dumps({
            "case": name, "shape": [B, S, di, N], "x_dtype": xdt, "T": T,
            "blocks": clk[9], "chunks_a_block": clk[8] / max(clk[9], 1),
            "cycles_a_chunk": phases,
            "cycles_a_step": round(sum(phases.values()) / T, 1),
            "ms": ms}), flush=True)
        del dt, A, Bm, Cm, x, h0, dy, dh, ckpt, outs, ws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
