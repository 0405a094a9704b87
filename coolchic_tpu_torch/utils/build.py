"""Builds the port's native libraries (host C++ with g++, CUDA with nvcc)
into coolchic_tpu_torch/_build/, at first use, and binds the CUDA kernels.

A library is named after the hash of its source, so an edited source is
rebuilt and a stale build is never loaded. Each build writes a private
temporary file and renames it into place, so concurrent processes (test
workers) may build the same library at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CSRC = Path(__file__).resolve().parent.parent / "csrc"
# Every CUDA kernel of the port is built for the H100 (sm_90a) with these
# flags, then its -D defines.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600


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


class CudaKernel:
    """A CUDA kernel of csrc/<name>.cu whose host function <name>_launch
    takes `args` (ctypes types), then the stream, and returns a CUDA error
    (0 on success). It is built with nvcc at first use, one library per set
    of -D defines (a dict, in command-line order), and bound with ctypes.
    `deps`: the headers of csrc/ that it includes; `tags`: each define's tag
    in the library's stem (WFD_DP=20 tagged "dp" gives _dp20). `launches`
    counts the launches that returned 0."""

    def __init__(self, name: str, args: list, *, deps: tuple[str, ...] = (),
                 tags: dict[str, str] | None = None) -> None:
        self.name = name
        self.args = args
        self.deps = tuple(CSRC / d for d in deps)
        self.tags = tags or {}
        self.launches = 0
        self._fns: dict[tuple, object] = {}

    def fn(self, defines: dict[str, int]):
        """The bound launch function of the build `defines`."""
        key = tuple(defines.items())
        if key not in self._fns:
            stem = self.name + "".join(f"_{self.tags[k]}{v}" for k, v in key)
            path = build_shared_library(
                CSRC / f"{self.name}.cu", stem,
                [find_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in key)],
                timeout=NVCC_TIMEOUT_S, deps=self.deps)
            f = getattr(ctypes.CDLL(str(path)), f"{self.name}_launch")
            f.argtypes = [*self.args, ctypes.c_void_p]
            f.restype = ctypes.c_int
            self._fns[key] = f
        return self._fns[key]

    def launch(self, defines: dict[str, int], *args) -> None:
        """Launch the build `defines` on `args` (a tensor passes its data
        pointer), on the current stream of the first tensor's device."""
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(dev):
            err = self.fn(defines)(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1
