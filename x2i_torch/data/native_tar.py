"""ctypes binding of the native tar reader (``native/tarindex.cpp``), the
counterpart of ``x2i_tpu/data/native_tar.py``.

The library is built at first use with g++ into the ignored
``x2i_torch/_build/`` (its name carries a hash of the source, so an edit
rebuilds it) and does the header walk and the member reads in C++ with
``pread``, outside the interpreter lock. A shard it cannot index (a pax
archive: the index returns -2) goes to the ``tarfile`` reader in
``webdataset.tar_samples``, as in JAX: that is a property of the archive.
A failed build sends every shard there; ``TAR_INDEX.loaded()`` says
whether the library loaded, so that a caller can refuse the slow path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from x2i_torch.data.webdataset import group_members

log = logging.getLogger("x2i_torch.data.native")

SRC = Path(__file__).resolve().parents[2] / "native" / "tarindex.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
MAX_ENTRIES = 1 << 20
FIRST_ENTRIES = 4096


class TarEntry(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char * 256),
                ("offset", ctypes.c_int64),
                ("size", ctypes.c_int64)]


class TarIndexLibrary:
    """The built library, loaded once per process (None after a failed
    build, which is logged and not retried)."""

    def __init__(self, src: Path = SRC):
        self.src = src
        self._lib = None
        self._tried = False
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.src.read_bytes()
                                + " ".join(GXX_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"tarindex_{digest[:12]}.so"

    def _build(self) -> Optional[Path]:
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp),
                            str(self.src)], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError) as exn:
            log.warning("native tar build failed (%r); using the python "
                        "reader", exn)
            return None
        os.replace(tmp, path)
        return path

    def lib(self):
        with self._lock:
            if self._lib is None and not self._tried:
                self._tried = True
                path = self._build()
                if path is not None:
                    lib = ctypes.CDLL(str(path))
                    lib.tar_index.restype = ctypes.c_int64
                    lib.tar_index.argtypes = [ctypes.c_char_p,
                                              ctypes.POINTER(TarEntry),
                                              ctypes.c_int64]
                    lib.tar_read.restype = ctypes.c_int64
                    lib.tar_read.argtypes = [ctypes.c_char_p,
                                             ctypes.c_int64,
                                             ctypes.c_int64,
                                             ctypes.c_char_p]
                    self._lib = lib
        return self._lib

    def loaded(self) -> bool:
        """Whether the native library built and loaded."""
        return self.lib() is not None


TAR_INDEX = TarIndexLibrary()


def index_tar(path: str, max_entries: int = MAX_ENTRIES
              ) -> Optional[List[Tuple[str, int, int]]]:
    """-> [(member name, payload offset, size)] of the regular files (the
    first ``max_entries``), or None when the library is missing or the
    archive needs the python reader. The index counts every member, so a
    table of ``FIRST_ENTRIES`` is tried first and one of the count after
    it (JAX allocates ``max_entries`` rows, 285 MB, for every shard)."""
    lib = TAR_INDEX.lib()
    if lib is None:
        return None
    size = min(FIRST_ENTRIES, max_entries)
    while True:
        arr = (TarEntry * size)()
        n = lib.tar_index(path.encode(), arr, size)
        if n < 0:
            return None
        if n <= size or size == max_entries:
            break
        size = min(n, max_entries)
    return [(arr[i].name.decode(errors="replace"), arr[i].offset,
             arr[i].size) for i in range(min(n, size))]


def read_member(path: str, offset: int, size: int) -> bytes:
    buf = ctypes.create_string_buffer(size)
    got = TAR_INDEX.lib().tar_read(path.encode(), offset, size, buf)
    return buf.raw[:got]


def native_tar_samples(path: str) -> Optional[Iterator[Dict]]:
    """Webdataset samples of one shard through the native index; None when
    the archive needs the python reader."""
    idx = index_tar(path)
    if idx is None:
        return None
    return group_members(
        ((name, lambda o=offset, s=size: read_member(path, o, s))
         for name, offset, size in idx), path)
