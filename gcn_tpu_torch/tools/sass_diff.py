#!/usr/bin/env python3
"""Which kernels another checkout compiles to the same machine code.

    python3 gcn_tpu_torch/tools/sass_diff.py --tree DIR [--sources A,B]

Builds every ``csrc/*.cu`` of this checkout and of the checkout at
``DIR`` (a parent commit unpacked into a gitignored directory) with the
package's ``nvcc`` flags, all at once, into ``gcn_tpu_torch/_build/sass/``,
disassembles each library (``cuobjdump -sass``) and reads each kernel's
registers (``cuobjdump -res-usage``).  A kernel of ``DIR`` whose SASS,
instruction for instruction, is also a kernel of this checkout's library
of the same source (under any name: a template made a plain function
keeps its code) computes the same bits in the same time; one without
such a twin changed.  Prints one JSON line per source: its kernels as
``same`` (with their registers) and ``changed``, and this checkout's
kernels that ``DIR`` does not have.  ``--sources`` names some sources
only.  Needs nvcc and cuobjdump (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)


def tool(name: str) -> str:
    """A CUDA toolkit program beside nvcc."""
    from gcn_tpu_torch.ops._cuda import _nvcc

    path = os.path.join(os.path.dirname(_nvcc()), name)
    return path if os.path.exists(path) else (shutil.which(name) or name)


def kernels(lib: str) -> dict:
    """{mangled name: (SASS lines without addresses, registers)} of a
    library's kernels."""
    sass = subprocess.run([tool("cuobjdump"), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and "/*" in line:
            code = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            if code and not code.startswith("/*"):
                out[name].append(code)
    res = subprocess.run([tool("cuobjdump"), "-res-usage", lib], check=True,
                         capture_output=True, text=True).stdout
    regs, name = {}, None
    for line in res.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and name:
            regs[name] = int(m.group(1))
    return {k: ("\n".join(v), regs.get(k)) for k, v in out.items()}


def main(argv=None) -> int:
    from gcn_tpu_torch.ops._cuda import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", required=True)
    parser.add_argument("--sources", default="")
    args = parser.parse_args(argv)
    other = os.path.join(os.path.abspath(args.tree), "gcn_tpu_torch", "csrc")
    stems = sorted(p.stem for p in CSRC.glob("*.cu"))
    if args.sources:
        stems = [s for s in stems if s in args.sources.split(",")]
    out_dir = os.path.join(BUILD_DIR, "sass")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for side, csrc in (("this", str(CSRC)), ("tree", other)):
        for stem in stems:
            src = os.path.join(csrc, f"{stem}.cu")
            if not os.path.exists(src):
                continue
            lib = os.path.join(out_dir, f"{side}_{stem}.so")
            procs[side, stem] = (lib, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (side, stem), (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {side} {stem}:\n{log}")
    for stem in stems:
        if ("tree", stem) not in procs:
            continue
        mine = kernels(procs["this", stem][0])
        theirs = kernels(procs["tree", stem][0])
        bodies = {}
        for name, (code, regs) in mine.items():
            bodies.setdefault(code, []).append(name)
        same, changed = {}, []
        for name, (code, regs) in theirs.items():
            if code in bodies:
                same[name] = {"registers": regs, "here": bodies[code]}
            else:
                changed.append(name)
        matched = {n for v in same.values() for n in v["here"]}
        print(json.dumps({"source": stem, "same": same, "changed": changed,
                          "new_here": {n: mine[n][1] for n in mine
                                       if n not in matched}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
