#!/usr/bin/env python3
"""SASS instructions in the main loop of a kernel, from ``cuobjdump -sass``.

For each function of the given objects or libraries whose name holds
--kernel (default ``parse_lanes_kernel``), finds the loop as the longest
backward branch and prints its instruction count and the count of each
opcode. The lane parse's loop is one word step (4 substeps).

    python3 scripts/sass_loop.py build/lzs_tpu_torch/liblzs_tpu_torch_*.so

With --dump DIR, each matched function's whole SASS goes to a file there.

Needs the CUDA toolkit's cuobjdump (PATH, CUDA_HOME or /usr/local/cuda).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess


def cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")


def functions(sass: str):
    """(name, [(address, instruction)]) of each function in a dump."""
    for part in re.split(r"\n\s+Function : ", sass)[1:]:
        name = part.split("\n")[0].strip()
        code = [(int(a, 16), t.strip()) for a, t in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        yield name, code


def main_loop(code):
    """The instructions between the longest backward branch and its
    target."""
    best = None
    for addr, text in code:
        m = re.search(r"BRA\s.*0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            span = (int(m.group(1), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    if best is None:
        return []
    return [t for a, t in code if best[0] <= a <= best[1]]


def opcode(text: str) -> str:
    words = text.split()
    op = words[1] if words[0].startswith("@") else words[0]
    return op.split(".")[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--kernel", default="parse_lanes_kernel")
    ap.add_argument("--dump", help="directory for each function's SASS")
    args = ap.parse_args()
    for path in args.files:
        sass = subprocess.run([cuobjdump(), "-sass", path], check=True,
                              capture_output=True, text=True).stdout
        for name, code in functions(sass):
            if args.kernel not in name:
                continue
            if args.dump:
                os.makedirs(args.dump, exist_ok=True)
                out = os.path.join(args.dump, re.sub(r"\W", "_", name)[:120]
                                   + ".sass")
                with open(out, "w") as f:
                    f.writelines(f"/*{a:04x}*/ {t};\n" for a, t in code)
            body = main_loop(code)
            ops = collections.Counter(opcode(t) for t in body)
            print(f"{os.path.basename(path)} {name}: {len(code)} "
                  f"instructions, loop {len(body)}: "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common()))


if __name__ == "__main__":
    main()
