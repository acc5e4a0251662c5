"""Compare the machine code (SASS) of the solver's kernels between two
checkouts: does a change of the sources change what the card runs?

    python -m nmpc_tpu_torch.tools.sass_diff OTHER_CHECKOUT [M | N,NU]

builds the solver library for M robots (default 6, the main path), or K3's
library at the stage shape (N, NU) (csrc/riccati_shape.cu), in this
checkout and in OTHER_CHECKOUT, each with its own nmpc_tpu_torch/ops/cuda_build
(a subprocess for the other), disassembles both with cuobjdump -sass and
prints, per kernel, its instruction count in each and whether the two listings
are identical (addresses and encodings included), else how many lines differ.
Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
from pathlib import Path

from nmpc_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[2]


def canonical(name: str) -> str:
    """A kernel's mangled name with K1's and K2's obstacle flag dropped where
    it is false: the pair-only kernels keep their name across the change
    that added the flag (inner_solve_kernel<6> and <6, false> compare)."""
    return re.sub(r"(inner_solve_kernel|al_update_kernel)ILi(\d+)ELb0EE", r"\1ILi\2EE", name)


def functions(sass: str) -> dict[str, list[str]]:
    """{mangled kernel name (canonical): its SASS lines, whitespace
    collapsed} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = canonical(m[1])
            out[name] = []
        elif name is not None and line.strip().startswith("/*"):
            out[name].append(" ".join(line.split()))   # cuobjdump pads to the name's length
    return out


def instructions(lines: list[str]) -> int:
    """Instructions in a function's lines: those with an address."""
    return sum(1 for line in lines if re.match(r"/\*[0-9a-f]{4,}\*/", line))


def compare(a: dict, b: dict) -> dict[str, tuple]:
    """Per kernel of either listing: (instructions in a, instructions in b,
    lines that differ; None where one side lacks the kernel)."""
    out = {}
    for name in sorted(a.keys() | b.keys()):
        if name not in a or name not in b:
            out[name] = (instructions(a.get(name, [])), instructions(b.get(name, [])), None)
            continue
        diff = difflib.unified_diff(a[name], b[name], lineterm="", n=0)
        changed = sum(1 for d in diff if d[:1] in "+-" and d[:3] not in ("+++", "---"))
        out[name] = (instructions(a[name]), instructions(b[name]), changed)
    return out


def library(root: Path, m) -> str:
    """Path of the solver library for m robots, or of K3's library at the
    stage shape m = (n, nu), built by root's own sources."""
    shape = isinstance(m, tuple)
    if root.resolve() == ROOT:
        if shape:
            cuda_build.load_k3_shape(*m)
            return cuda_build.k3_shape_build_info[m]["path"]
        cuda_build.load(m)
        return cuda_build.build_info[m]["path"]
    load, info = ((f"load_k3_shape(*{m})", f"k3_shape_build_info[{m}]") if shape
                  else (f"load({m})", f"build_info[{m}]"))
    code = (f"from nmpc_tpu_torch.ops import cuda_build\ncuda_build.{load}\n"
            f"print(cuda_build.{info}['path'])\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, check=True)
    return proc.stdout.strip().splitlines()[-1]


def sass(path: str) -> str:
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other, m = Path(argv[0]), cuda_build.BENCH_ROBOTS
    if len(argv) > 1:
        m = tuple(map(int, argv[1].split(","))) if "," in argv[1] else int(argv[1])
    rows = compare(functions(sass(library(ROOT, m))), functions(sass(library(other, m))))
    what = f"K3 library at (n, nu) = {m}" if isinstance(m, tuple) else f"m={m} solver library"
    print(f"SASS of the {what}: this checkout against {other}")
    for name, (na, nb, changed) in rows.items():
        verdict = ("missing on one side" if changed is None
                   else "identical" if changed == 0 else f"{changed} lines differ")
        print(f"  {name}: {na} / {nb} instructions, {verdict}")
    same = all(c == 0 for *_, c in rows.values() if c is not None)
    only = [name for name, (*_, c) in rows.items() if c is None]
    print(f"kernels of both checkouts identical: {'yes' if same else 'no'}; in one only: "
          f"{', '.join(only) or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
