#!/usr/bin/env python3
"""Where a step of K7b's bf16 dK/dV and dQ loops spends its cycles.

    python3 tools/k7b_phase_clocks.py [case ...]   (default: qwen3_train_1024)

Writes ``build/k7b_clocks.cu``: ``flash_backward.cu`` with ``clock64()``
read by thread 0 of each block at the loops' phase boundaries (the stage
wait, the barrier, the score products, forming P and dS, the
accumulating products), builds it with ``nvcc`` beside a small C entry
point into ``build/k7b_clocks.so`` (seconds; no PyTorch headers), runs
each case of ``chip_smoke.K7B_CASES`` once on the card and prints the
mean cycles of each phase per step (dK/dV: a (q head, q tile) step; dQ:
a key tile), as thread 0 of warp 0 sees them.  The clock reads order the
code around them, so the phases sum to a little more than an
uninstrumented step.  Needs a card and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FA = os.path.join(ROOT, "src/repro_torch/kernels/flash_attention/csrc")
INC = os.path.join(ROOT, "src/repro_torch/kernels/csrc")
OUT = os.path.join(ROOT, "build")

ENTRY = r'''
extern "C" int k7b_bwd(const void* q, const void* k, const void* v,
                       const void* dout, float* lse, float* delta, void* dq,
                       void* dk, void* dv, int B, int Sq, int Skv, int H,
                       int K, int D, int skv, int q_offset, int causal,
                       int window, void* stream) {
  FlashArgs a{};
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.K = K; a.skv = skv;
  a.q_offset = q_offset; a.causal = causal; a.window = window;
  a.scale = (float)(1.0 / sqrt((double)D));
  return (int)launch_flash_attention_bwd(q, k, v, dout, lse, delta, dq, dk,
                                         dv, a, D, 1, (cudaStream_t)stream);
}

extern "C" int k7b_clocks(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[32] = {0};
    return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_clk,
                                   sizeof(unsigned long long) * 32);
}
'''

# (kernel, loop head, [(text a phase ends before, phase)], loop end, slot
#  of g_clk, steps, phase names); phase 6 runs to the loop's end
LOOPS = (
    ("fa_bwd_dkdv_wgmma_kernel(", "    for (int i = 0; i < n; ++i) {", [
        ("      __syncthreads();", 0),
        ("      const uint32_t Qs = QO", 1),
        ("#pragma unroll\n      for (int j = 0; j < NS; ++j) {\n"
         "        const float2 lr", 2),
        ("      uint32_t ph[4][4]", 3),
        ("#pragma unroll\n      for (int j = 0; j < NS; ++j) {\n"
         "        const float2 dr", 4),
        ("      fa::split_a64(pacc, sh, sl);", 5),
    ], "    }\n", 0, "n",
     ("stage wait", "barrier", "score products", "P", "split P, issue dV",
      "dS", "split dS, dK and dV products")),
    ("fa_bwd_dq_wgmma_kernel(", "  for (int t = t0; t < t1; ++t) {", [
        ("    __syncthreads();", 0),
        ("    // S = Q K^T and dP = dO V^T", 1),
        ("    const int k_lo = t * BT;", 2),
        ("    // dQ += dS_hi K + dS_lo K", 3),
        ("    fa::reg_fence<D / 2>(dqa);\n    fa::wg_fence();", 4),
    ], "  }\n", 16, "t1 - t0",
     ("stage wait", "barrier", "score products", "P and dS", "split dS",
      "", "dQ products")),
)


def instrument(src: str) -> str:
    head = ("__device__ unsigned long long g_clk[32];\n"
            "#define PT(i) do { unsigned long long _n = clock64(); "
            "pc[i] += _n - _t; _t = _n; } while (0)\n")
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    for kernel, loop_head, marks, end, slot, steps, _ in LOOPS:
        pos = src.index(loop_head, src.index(kernel))
        src = (src[:pos] + "  unsigned long long pc[8] = {0}; "
               "unsigned long long _t = clock64();\n" + src[pos:])
        for text, i in marks:
            j = src.index(text, pos)
            src = src[:j] + f"PT({i});\n" + src[j:]
            pos = j + len(f"PT({i});\n") + len(text)
        j = src.index(end, pos)
        src = src[:j] + "PT(6);\n" + src[j:]
        j = src.index(end, j) + len(end)
        src = (src[:j] + f"  if (threadIdx.x == 0) {{ for (int u = 0; u < 8;"
               f" ++u) atomicAdd(&g_clk[{slot} + u], pc[u]); "
               f"atomicAdd(&g_clk[{slot} + 8], (unsigned long long)"
               f"({steps})); }}\n" + src[j:])
    return src + ENTRY


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "k7b_clocks.cu")
    so = os.path.join(OUT, "k7b_clocks.so")
    with open(os.path.join(FA, "flash_backward.cu")) as f:
        src = f.read()
    with open(cu, "w") as f:
        f.write('#include <math.h>\n' + instrument(src))
    r = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode",
         "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-I", INC, "-I", FA, "-o", so, cu],
        capture_output=True, text=True)
    if r.returncode:
        print(r.stderr[-3000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.k7b_bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    lib.k7b_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    from repro_torch.kernels.flash_attention.ops import BWD_TILE

    dev = torch.device("cuda", 0)
    cases = {c[0]: c for c in cs.K7B_CASES}
    print(cs.nvidia_smi())
    for name in sys.argv[1:] or ["qwen3_train_1024"]:
        (_, B, Sq, Skv, H, K, D, causal, window, q_offset, skv,
         dt) = cases[name]
        if dt != "bfloat16":
            print(f"{name}: the f32 instance has no phases here")
            continue
        skv = Skv if skv is None else skv
        q, k, v, do = cs.k7b_inputs(dev, B, Sq, Skv, H, K, D, dt, 7)
        lse = torch.empty((B, H, -(-Sq // BWD_TILE) * BWD_TILE),
                          dtype=torch.float32, device=dev)
        delta = torch.empty_like(lse)
        grads = [torch.empty_like(t) for t in (q, k, v)]

        def run():
            rc = lib.k7b_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(),
                *(g.data_ptr() for g in grads), B, Sq, Skv, H, K, D, skv,
                q_offset, int(causal), window,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        run()
        torch.cuda.synchronize()
        lib.k7b_clocks(None, 1)
        run()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 32)()
        lib.k7b_clocks(ctypes.cast(out, ctypes.c_void_p), 0)
        o = list(out)
        for (kernel, *_, slot, _s, names) in LOOPS:
            what = kernel.split("_")[2]
            steps = max(o[slot + 8], 1)
            phases = {names[i]: round(o[slot + i] / steps)
                      for i in range(7) if names[i]}
            print(f"{name} {what}: {o[slot + 8]} steps, cycles a step "
                  f"(thread 0): {phases}, sum {sum(phases.values())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
