#!/usr/bin/env python3
"""Count the SASS instructions of the port's built kernels, by opcode.

    python3 tools/sass_count.py 'selective_scan_kernelILi16ELb1ELb1E'

Runs ``cuobjdump -sass`` on the extension that ``repro_torch.kernels._ext``
builds (``build/torch_kernels/``; it builds it first if it is missing)
and prints one JSON line per function whose mangled name matches each
regular expression given: its static instruction count (NOP excluded)
and a count by opcode (the mnemonic before the first ``.``).  A static
count says what one pass over the code issues; divide by what an
unrolled loop covers to get a count per element.  Needs the CUDA
toolkit's ``cuobjdump`` (``/usr/local/cuda/bin`` or on ``PATH``).
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def library() -> str:
    sys.path[:0] = [os.path.join(ROOT, "src")]
    from repro_torch.kernels import _ext

    found = glob.glob(str(_ext.BUILD_DIR / "*.so"))
    if not found:
        _ext.extension()
        found = glob.glob(str(_ext.BUILD_DIR / "*.so"))
    return found[0]


def functions(sass: str) -> dict:
    """{mangled name: [opcode, ...]} from ``cuobjdump -sass`` text."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if name and m and m.group(1) != "NOP":
            out[name].append(m.group(1))
    return out


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", library()], check=True,
                          capture_output=True, text=True).stdout
    fns = functions(sass)
    for pattern in sys.argv[1:]:
        for name, ops in fns.items():
            if re.search(pattern, name):
                print(json.dumps({"function": name, "instructions": len(ops),
                                  "by_opcode": dict(collections.Counter(
                                      ops).most_common())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
