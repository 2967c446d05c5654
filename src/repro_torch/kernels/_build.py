"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for ``sm_90a`` into a shared library under ``build/repro_torch/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
its source, the shared headers (``csrc/*.cuh``) and the flags, and loaded
with ``ctypes``. Nothing is built when a module is imported, and nothing
is built for a tensor on the CPU.

Flags: ``-O3``, no ``--use_fast_math`` (the quantizers need IEEE division
and ``rintf``), and ``--fmad=false`` so that the compiler contracts no
multiply-add the source did not write as ``fmaf``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`Kernel.launch` raises if that is not 0 and
adds one to ``Kernel.launches`` and to the entry's count in
``Kernel.entry_launches`` when it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

__all__ = ["Kernel", "build_all", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo")

P = ctypes.c_void_p
I = ctypes.c_int


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from the CUDA toolkit torch found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "src/repro_torch/kernels/csrc at first use on the card")


class Kernel:
    """One CUDA source file: its library, its C entry points and its count
    of launches.

    ``entries`` maps each C function to its ``argtypes``; every entry
    returns ``int`` (a ``cudaError_t``).
    """

    def __init__(self, name: str, entries: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.entries = dict(entries)
        self.launches = 0
        self.entry_launches = {e: 0 for e in self.entries}
        self._lib = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- build
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        """Start ``nvcc`` for this source unless its library exists;
        returns ``(process, tmp, final)`` or None."""
        final = self.library_path()
        if final.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = final.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, final

    @staticmethod
    def _finish_build(started) -> None:
        proc, tmp, final = started
        out, _ = proc.communicate()
        final.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {final.name}:\n{out}")
        os.replace(tmp, final)

    def build_log(self) -> str:
        log = self.library_path().with_suffix(".log")
        return log.read_text() if log.exists() else ""

    # -------------------------------------------------------------- load
    def lib(self):
        with self._lock:
            if self._lib is None:
                started = self._start_build()
                if started is not None:
                    self._finish_build(started)
                lib = ctypes.CDLL(str(self.library_path()))
                for fn, argtypes in self.entries.items():
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def launch(self, entry: str, *args) -> None:
        """Call one C entry point; raise on a launch error, else count."""
        rc = getattr(self.lib(), entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{entry}: CUDA error {rc} at "
                               "launch")
        self.launches += 1
        self.entry_launches[entry] += 1

    def reset_counts(self) -> None:
        self.launches = 0
        self.entry_launches = dict.fromkeys(self.entries, 0)


def build_all(kernels: Iterable[Kernel]) -> List[Kernel]:
    """Build every kernel's library at once (one ``nvcc`` per source, all
    started together), then load each."""
    kernels = list(kernels)
    started = [(k, k._start_build()) for k in kernels]
    errors = []
    for k, s in started:
        if s is not None:
            try:
                Kernel._finish_build(s)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.lib()
    return kernels
