"""Builds the port's native libraries (host C++ with g++, CUDA with nvcc)
into coolchic_tpu_torch/_build/, at first use.

A library is named after the hash of its source, so an edited source is
rebuilt and a stale build is never loaded. Each build writes a private
temporary file and renames it into place, so concurrent processes (test
workers) may build the same library at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def build_shared_library(src: Path, stem: str, compile_cmd: list[str],
                         timeout: float | None = None, deps: tuple[Path, ...] = ()) -> Path:
    """Compile `src` into BUILD_DIR/lib<stem>-<hash>.so unless present.
    compile_cmd is the compiler and its flags; the source and `-o <out>`
    are appended. `deps` are the headers `src` includes, hashed with it.
    Raises subprocess.TimeoutExpired after `timeout` s."""
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in (src, *deps))
                            + " ".join(compile_cmd).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{stem}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(compile_cmd + [str(src), "-o", str(tmp)], check=True,
                       timeout=timeout)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built at first use on a machine with a card")
    return found
