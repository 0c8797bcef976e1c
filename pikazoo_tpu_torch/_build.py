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


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    """Where the library built from ``sources`` (names under ``csrc/``) lives.
    The name hashes the headers under ``csrc/`` too, since a source may
    include any of them."""
    headers = sorted(p.name for p in CSRC_DIR.iterdir()
                     if p.suffix in HEADER_SUFFIXES)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *headers):
        digest.update(src.encode())
        digest.update((CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, sources: tuple[str, ...]) -> Path:
    """Compile ``sources`` into ``build/kernels/`` unless an up-to-date
    library is there; returns its path."""
    out = library_path(name, sources)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in sources)]
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
