"""Count the SASS instructions of the kernels in a CUDA source, by opcode.

Compiles the source with the flags of :mod:`.build` into a cubin and reads
it back with ``cuobjdump -sass``; prints, per kernel, ptxas's register and
spill line, the instruction count and the most frequent opcodes.  Needs
nvcc and cuobjdump (the card's machine has both):

    PYTHONPATH=src python -m repro_torch.kernels.sass src/repro_torch/kernels/csrc/alloc_scan.cu
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from . import build


def opcodes(source: Path) -> tuple[str, dict]:
    """(ptxas's report, {kernel: Counter of opcodes}) of ``source``."""
    nvcc = build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        out = subprocess.run([nvcc, *build.ARCH, *build.FLAGS, "-cubin",
                              str(source), "-o", str(cubin)],
                             capture_output=True, text=True, check=True)
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                              capture_output=True, text=True, check=True)
    kernels, name = {}, None
    for line in sass.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and name is not None:
            kernels[name][m.group(1).split(".")[0]] += 1
    return out.stdout + out.stderr, kernels


def main(argv) -> int:
    for src in argv:
        report, kernels = opcodes(Path(src))
        print(f"== {src}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
        for name, ops in kernels.items():
            top = ", ".join(f"{op} {n}" for op, n in ops.most_common(12))
            print(f"  {name}: {sum(ops.values())} instructions; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
