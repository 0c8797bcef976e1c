"""Build the port's CUDA kernels from the sources in this checkout.

Each library is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  The build happens
at first use, into ``build/kernels/`` at the root of the checkout, named by
a hash of its flags, its sources and every header under ``csrc/``, so a
changed source or header is rebuilt and an unchanged one is reused.  A
failed build raises with ``nvcc``'s output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    :data:`DEFAULT_NVCC`."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", DEFAULT_NVCC]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise KernelBuildError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH and {DEFAULT_NVCC}); "
        "the CUDA kernels of pikazoo_tpu_torch need the CUDA toolkit")


HEADER_SUFFIXES = (".cuh", ".h")


def library_path(name: str, sources: tuple[str, ...],
                 csrc: Path | None = None) -> Path:
    """Where the library built from ``sources`` (names under ``csrc``, by
    default the package's ``csrc/``) lives.  The name hashes the headers
    under ``csrc`` too, since a source may include any of them."""
    csrc = csrc or CSRC_DIR
    headers = sorted(p.name for p in csrc.iterdir()
                     if p.suffix in HEADER_SUFFIXES)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *headers):
        digest.update(src.encode())
        digest.update((csrc / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, sources: tuple[str, ...], csrc: Path | None = None) -> Path:
    """Compile ``sources`` (under ``csrc``, by default the package's) into
    ``build/kernels/`` unless an up-to-date library is there; returns its
    path."""
    csrc = csrc or CSRC_DIR
    out = library_path(name, sources, csrc)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(csrc / s) for s in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build if needed, then load the library."""
    return ctypes.CDLL(str(build(name, sources)))


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def resource_usage(source: Path, notes: list | None = None) -> list[tuple[str, int, int, int, int]]:
    """``nvcc -Xptxas -v`` of one source, compiled to a cubin with the port's
    flags: (mangled kernel name, registers, stack bytes, spill store bytes,
    spill load bytes) for each kernel instance.  ``notes``, if given, takes
    ptxas's performance warnings (e.g. wgmma serialized)."""
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmd = [find_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o",
               os.path.join(tmp, "k.cubin"), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed ({proc.returncode}) on {source}:\n"
                               f"{proc.stdout}{proc.stderr}")
    kernels, entry, frame = [], None, (-1, -1, -1)
    for line in (proc.stdout + proc.stderr).splitlines():
        if notes is not None and "Performance Loss" in line:
            notes.append(line.strip())
        if m := _PTXAS_ENTRY.search(line):
            entry = m.group(1)
        elif m := _PTXAS_FRAME.search(line):
            frame = tuple(int(v) for v in m.groups())
        elif (m := _PTXAS_REGS.search(line)) and entry:
            kernels.append((entry, int(m.group(1)), *frame))
            entry, frame = None, (-1, -1, -1)
    return kernels
