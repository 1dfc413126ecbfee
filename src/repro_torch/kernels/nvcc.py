"""Build the port's CUDA C++ kernels with nvcc, at first use.

Each kernel module keeps one ``.cu`` source under ``csrc/`` with a plain
C interface and calls :func:`build` with it and its flags.  The shared
library lands in ``_build/`` (listed in .gitignore) under a name that
hashes the source and the flags, so an edit to either builds anew and
an unchanged pair reuses the library.  The file is written to a
temporary name and renamed into place, so a reader never sees a
partial library; the compiler's output is kept beside it (``.log``), so
a reused library still reports its registers and spills
(:func:`ptxas_report`).  Builds of different sources may run at once
(from threads: ``subprocess.run`` waits without the interpreter lock).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

#: where the shared libraries are built (listed in .gitignore).
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: flags every kernel library is built with: Hopper (sm_90a), a shared
#: library with a C interface, and ptxas's register and spill report.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float      # 0.0 when an up-to-date library was reused
    log: str            # nvcc/ptxas output (register and spill report)


@dataclasses.dataclass
class PtxasEntry:
    """ptxas's report of one kernel (entry function) of a build."""
    name: str           # the mangled name
    registers: int
    barriers: int       # hardware barriers (__syncthreads' and named ones)
    spill_stores: int   # bytes
    spill_loads: int    # bytes


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "CUDA kernels are built from source at first use")
    return found


def library_path(source: Path, flags: Sequence[str],
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``source`` with ``flags`` lives: the
    name carries a hash of both."""
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir / f"{source.stem}-{key}.so"


def build(source: Path, flags: Sequence[str] = BASE_FLAGS,
          build_dir: Path = BUILD_DIR) -> BuildInfo:
    """Compile ``source`` into ``build_dir`` unless a library built from
    the same source and flags is already there (then its saved log is
    returned)."""
    out = library_path(source, flags, build_dir)
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(out, 0.0, log)
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log = proc.stdout + proc.stderr
        with open(tmp + ".log", "w") as fh:
            fh.write(log)
        os.replace(tmp + ".log", log_path)
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    finally:
        for path in (tmp, tmp + ".log"):
            if os.path.exists(path):
                os.unlink(path)
    return BuildInfo(out, time.perf_counter() - t0, log)


def ptxas_report(log: str) -> list[PtxasEntry]:
    """Each entry function's registers, barriers and spill bytes, in the
    order ptxas reports them (``-Xptxas -v``)."""
    entries = []
    for block in re.split(r"Compiling entry function '", log)[1:]:
        name = block.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers(?:, used (\d+) barriers)?",
                         block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        entries.append(PtxasEntry(
            name, int(regs.group(1)) if regs else -1,
            int(regs.group(2) or 0) if regs else -1,
            int(spill.group(1)) if spill else -1,
            int(spill.group(2)) if spill else -1))
    return entries


def ptxas_warnings(log: str) -> list[str]:
    """ptxas's warnings (serialised wgmma, an ignored ``setmaxnreg``,
    ...), one line each."""
    return [ln.strip() for ln in log.splitlines() if "warning" in ln.lower()]


def raise_on(status: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error (0 is success)."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")
