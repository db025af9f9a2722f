"""Build and load one of the port's CUDA sources (``x2i_torch/csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under the ignored
``x2i_torch/_build/``, and loaded with ``ctypes``. The library's name
carries a hash of the source and the flags, so an edit rebuilds it. Each
library keeps the launch counts of its kernels, which its wrappers raise
by one per launch.

``ptxas_report`` reads what ``ptxas -v`` said of a build: each kernel's
registers and spills, and whether its ``wgmma`` pipeline was serialized;
``build_faults`` lists what in it would leave a kernel right but several
times slower with no other sign. ``refuse_grad`` is the guard of
every kernel wrapper without a backward.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# --split-compile 0: the optimizer and ptxas run on all the host's cores, one
# kernel each (flash_fwd.cu has 24 instances of its kernel: 28 s on one
# core, 12 s on eight)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "--split-compile", "0")


class CudaLibrary:
    """One source file's library (built once per process) and its launch
    counts. ``bind(lib)`` sets the ctypes signatures of its C functions.
    The build gate (``build_faults`` on ``gated_kernels``) looks for every
    kernel of ``wgmma_kernels`` (those built on ``wgmma``) and of
    ``checked_kernels`` (the others) alike: the split names what each
    kernel is built on and changes nothing the gate does."""

    def __init__(self, source: str, stem: str, kernels: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None],
                 wgmma_kernels: Sequence[str] = (),
                 checked_kernels: Sequence[str] = ()):
        self.src = CSRC / source
        self.stem = stem
        self.launches = {name: 0 for name in kernels}
        self.wgmma_kernels = tuple(wgmma_kernels)
        self.gated_kernels = self.wgmma_kernels + tuple(checked_kernels)
        self.build_log = ""
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        # the source, the shared headers and the flags
        parts = [self.src.read_bytes(), " ".join(NVCC_FLAGS).encode()]
        parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
        digest = hashlib.sha256(b"".join(parts)).hexdigest()[:12]
        return BUILD_DIR / f"{self.stem}_{digest}.so"

    def build(self) -> Path:
        """Compile the source with nvcc for sm_90a (seconds)."""
        path = self.library_path()
        log = path.with_suffix(".log")
        if path.exists():
            # an earlier process built it: its log lies beside it
            self.build_log = log.read_text() if log.exists() else ""
            return path
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                               str(self.src)],
                              capture_output=True, text=True, check=False)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src}:\n"
                               f"{self.build_log}")
        log.write_text(self.build_log)
        os.replace(tmp, path)
        return path

    def lib(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
        return self._lib

    def reset_launches(self):
        for key in self.launches:
            self.launches[key] = 0


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SERIALIZED = re.compile(
    r"wgmma\.mma_async instructions are serialized.*?function '([^']+)'")


def ptxas_report(build_log: str) -> dict:
    """What ``ptxas -v`` said, per kernel (mangled entry name):
    ``{"registers": n, "spill_bytes": stores + loads, "wgmma_serialized":
    bool}``. ptxas names a kernel ("Compiling entry function"), then gives
    its spills and its registers; it reports a ``wgmma`` pipeline that it
    had to serialize (the kernel then runs far below the tensor cores'
    rate, with no other sign) on a line that names the function."""
    report: dict = {}

    def entry(name):
        return report.setdefault(name, {"registers": None, "spill_bytes": 0,
                                        "wgmma_serialized": False})

    current = None
    for line in build_log.splitlines():
        if m := _SERIALIZED.search(line):
            entry(m.group(1))["wgmma_serialized"] = True
        elif m := _ENTRY.search(line):
            current = entry(m.group(1))
        elif current is not None:
            if m := _SPILL.search(line):
                current["spill_bytes"] += int(m.group(1)) + int(m.group(2))
            elif m := _REGS.search(line):
                current["registers"] = int(m.group(1))
    return report


def build_faults(build_log: str, kernels: Sequence[str]) -> list:
    """What in a library's ptxas log leaves its kernels right but several
    times slower, with no other sign: spills in any kernel, a serialized
    ``wgmma`` pipeline, an ignored ``setmaxnreg`` (its consumers would keep
    a third of the register file and spill), and a log that names no
    kernel of ``kernels`` or gives a kernel no register count (a report
    that cannot be read). -> one line per fault; none for a clean build."""
    report = ptxas_report(build_log)
    faults = [f"{name}: {r['spill_bytes']} bytes of spills"
              for name, r in report.items() if r["spill_bytes"]]
    faults += [f"{name}: ptxas serialized its wgmma pipeline"
               for name, r in report.items() if r["wgmma_serialized"]]
    faults += [f"{name}: no register count" for name, r in report.items()
               if r["registers"] is None]
    if "'setmaxnreg' ignored" in build_log:
        faults.append("ptxas ignored setmaxnreg")
    faults += [f"the log names no kernel {kernel}" for kernel in kernels
               if not any(kernel in name for name in report)]
    return faults


def refuse_grad(kernel: str, *tensors):
    """Raise when autograd records and one of ``tensors`` requires grad:
    ``kernel`` is forward-only (as its TPU counterpart is), and returning
    its output detached would drop that part of every gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: call it under torch.no_grad() or "
            f"torch.inference_mode(), or take the plain route for training")
