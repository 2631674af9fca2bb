"""Build the CUDA sources under ``csrc/`` with nvcc, for loading by ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, a shared
library with a plain C interface, compiled for Hopper (``sm_90a``).  The hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source builds anew and an unchanged one is reused from the build
directory.  Nothing is compiled when
this module is imported: the kernels' wrappers call :func:`build` on first
use.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``$PATH``."""
    candidates = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"] \
        if os.environ.get("CUDA_HOME") else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH); the CUDA kernels are built on a machine with the "
            "CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed on its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path.

    nvcc's report (ptxas registers, shared memory, spills) is kept beside
    the library as ``.log``.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout
                                       + res.stderr)
    os.replace(tmp, out)
    return out
