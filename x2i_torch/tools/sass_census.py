"""Count a kernel's instructions on the card's special-function and
conversion units, per element, from its SASS.

    python x2i_torch/tools/sass_census.py BINARY NAME:ELEMENTS [...]

BINARY is a shared library built by nvcc or a cubin; each NAME:ELEMENTS
names a kernel by a substring of its mangled name and the elements one
thread of it handles per row. The kernels are assumed to be straight-line per row (their
loops over a row unrolled), so that the static counts divided by the
elements are the counts per element. Prints one JSON line per kernel:
the instructions of each class (MUFU: the special-function unit; F2I,
I2F, F2F and FRND: the conversion unit; F2FP, the packing conversion
that runs beside the FMA units, apart), in all and per element.
Needs the CUDA toolkit's ``cuobjdump``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

CLASSES = {"MUFU": ("MUFU",), "conversion": ("F2I", "I2F", "F2F", "FRND"),
           "F2FP": ("F2FP",)}
_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)[.\s;]")


def cuobjdump() -> str:
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def census(sass: str) -> dict:
    """{kernel: {opcode: count}} from ``cuobjdump -sass`` text."""
    out: dict = {}
    current = None
    for line in sass.splitlines():
        if m := _FUNC.match(line):
            current = out.setdefault(m.group(1), {})
        elif current is not None and (m := _INSN.search(line)):
            op = m.group(1)
            current[op] = current.get(op, 0) + 1
    return out


def classify(ops: dict, elements: int) -> dict:
    rec = {"instructions": sum(ops.values())}
    for name, opcodes in CLASSES.items():
        n = sum(c for op, c in ops.items() if op in opcodes)
        rec[name] = n
        rec[f"{name}_per_element"] = n / elements
    return rec


def main(argv) -> int:
    binary, specs = argv[0], argv[1:]
    sass = subprocess.run([cuobjdump(), "-sass", binary], capture_output=True,
                          text=True, check=True).stdout
    kernels = census(sass)
    for spec in specs:
        name, elements = spec.rsplit(":", 1)
        for kernel, ops in kernels.items():
            if name in kernel:
                print(json.dumps({"binary": Path(binary).name,
                                  "kernel": kernel,
                                  "elements_per_thread": int(elements),
                                  **classify(ops, int(elements))}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
