"""Static SASS instruction counts of the port's CUDA kernels.

    python3 dafne_torch/tools/sass_counts.py

Builds dafne_torch/csrc/*.cu as the kernels' wrappers do (nvcc, sm_90a),
disassembles each library with ``cuobjdump -sass`` and prints, per kernel,
its instructions, its f32 arithmetic (FADD, FMUL, FFMA, FSETP, FMNMX,
FSEL), its MUFU (the special-function unit: the reciprocal of each IEEE
division), its FCHK (a division's range check), its warpgroup MMAs (the
``*GMMA`` opcodes that ``wgmma.mma_async`` becomes: IGMMA for s8, HGMMA
for f16/bf16) and its TMA tensor loads (UTMALDG).  A count covers each
instruction once, however often it runs.  Needs the CUDA toolkit, not a
GPU.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

SOURCES = ("quad_nms", "assign", "int8_conv", "deform_conv")
F32_ARITHMETIC = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL")
_OPCODE = re.compile(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")


def sass_counts(lib_path: str):
    """{kernel: (instructions, f32 arithmetic, MUFU, FCHK, warpgroup MMA, TMA
    loads)} of a built library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0, 0, 0, 0, 0]
            continue
        m = _OPCODE.match(line)
        if name is None or not m:
            continue
        op, c = m.group(1), counts[name]
        c[0] += 1
        c[1] += op in F32_ARITHMETIC
        c[2] += op == "MUFU"
        c[3] += op == "FCHK"
        c[4] += op.endswith("GMMA")
        c[5] += op == "UTMALDG"
    return {k: tuple(v) for k, v in counts.items()}


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from dafne_torch.ops.kernels import build

    for source in SOURCES:
        build.build(source)
        for kernel, (total, f32, mufu, fchk, gmma, tma) in sass_counts(
                build.lib_path(source)).items():
            print(f"[sass {source}] {kernel}: {total} instructions, {f32} f32 arithmetic, "
                  f"{mufu} MUFU, {fchk} FCHK, {gmma} warpgroup MMA, {tma} TMA loads", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
