"""The loader of the port's CUDA kernels (utils/build.py:CudaKernel), on the
CPU: the compiler and ctypes are replaced by fakes, so that each kernel's
nvcc command, its library cache and its launch are checked without a card.
"""

import contextlib
import ctypes

import pytest
import torch

from coolchic_tpu_torch.ops import arm_wgrad as aw
from coolchic_tpu_torch.ops import small_grid_decode as sgd
from coolchic_tpu_torch.ops import wavefront_decode as wfd
from coolchic_tpu_torch.utils import build

NVCC = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC"]
# Per kernel: its builds for the ARM widths 20, 20 and 8 (hop's and lop's
# padded widths), then what each distinct build's nvcc run must be:
# (stem, the command's defines, headers).
CASES = {
    "wavefront_decode": (
        wfd.KERNEL, wfd.kernel_defines,
        [("wavefront_decode_dp20_t4", ["-DWFD_DP=20", "-DWFD_TEAM=4"], ["tpu_cdf.cuh"]),
         ("wavefront_decode_dp8_t4", ["-DWFD_DP=8", "-DWFD_TEAM=4"], ["tpu_cdf.cuh"])]),
    "small_grid_decode": (
        sgd.KERNEL, sgd.kernel_defines,
        [("small_grid_decode_dp20_t8", ["-DSGD_DP=20", "-DSGD_TEAM=8"], ["tpu_cdf.cuh"]),
         ("small_grid_decode_dp8_t8", ["-DSGD_DP=8", "-DSGD_TEAM=8"], ["tpu_cdf.cuh"])]),
    "arm_wgrad": (aw.KERNEL, lambda dim: {}, [("arm_wgrad", [], [])]),
}


class _FakeFn:
    """A library's launch function: records its calls, returns `err`."""

    def __init__(self):
        self.calls, self.err = [], 0
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _FakeStream:
    cuda_stream = 1234


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_build_and_launch(name, monkeypatch):
    kernel, defines_of, want = CASES[name]
    builds, libs = [], {}

    def fake_build(src, stem, cmd, timeout=None, deps=()):
        builds.append((src, stem, cmd, timeout, deps))
        return f"/fake/lib{stem}.so"

    def fake_cdll(path):
        libs[path] = lib = type("FakeLib", (), {})()
        setattr(lib, f"{name}_launch", _FakeFn())
        return lib

    monkeypatch.setattr(build, "build_shared_library", fake_build)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _FakeStream())
    monkeypatch.setattr(kernel, "_fns", {})
    monkeypatch.setattr(kernel, "launches", 0)

    # one library per distinct set of defines, each built by its nvcc command
    fns = [kernel.fn(defines_of(dim)) for dim in (20, 20, 8)]
    assert [(stem, cmd) for _, stem, cmd, _, _ in builds] == [
        (stem, NVCC + defs) for stem, defs, _ in want]
    for src, _, _, timeout, deps in builds:
        assert src == build.CSRC / f"{name}.cu" and timeout == 600
        assert [d.name for d in deps] == want[0][2]
    assert len(libs) == len(want) and fns[0] is fns[1]
    fn = fns[0]
    assert fn.argtypes == [*kernel.args, ctypes.c_void_p] and fn.restype is ctypes.c_int

    # a tensor passes its pointer, the stream comes last; 0 counts a launch
    t = torch.zeros(4, dtype=torch.int32)
    args = [t if a is ctypes.c_void_p else 7 for a in kernel.args]
    kernel.launch(defines_of(20), *args)
    assert kernel.launches == 1
    assert fn.calls == [tuple(t.data_ptr() if a is t else a for a in args) + (1234,)]

    # a CUDA error raises, names the kernel and counts nothing
    fn.err = 700
    with pytest.raises(RuntimeError, match=f"{name} kernel launch failed: CUDA error 700"):
        kernel.launch(defines_of(20), *args)
    assert kernel.launches == 1 and len(fn.calls) == 2


def test_wavefront_launch_args():
    """The wavefront kernel's argument list (shared by the decode path and
    chip_smoke.py's timing builds) holds a pointer where the launch function
    takes one and the build's own DP and team."""
    h, w, G, R, taps = 16, 24, 3, 64, ((-1, 0), (0, -1), (-2, 1))
    words = torch.zeros((R, G, wfd.LANES), dtype=torch.int32)
    ifce = torch.zeros((wfd.n_wavefronts(h, w), 1, G, wfd.LANES), dtype=torch.int32)
    small = [torch.zeros(1, dtype=torch.int32) for _ in range(4)]
    out = torch.zeros((G, h, w), dtype=torch.int32)
    defines = {**wfd.kernel_defines(5), "WFD_TEAM": 8}
    args = wfd.launch_args(defines, words, *small, ifce, out, h=h, w=w, taps=taps,
                           dims=((5, 5), (5, 2)), n_ifce=2, ifce_packed=True)
    assert [isinstance(a, torch.Tensor) for a in args] == [
        t is ctypes.c_void_p for t in wfd.KERNEL.args]
    assert args[6].tolist() == [-1, 0, 0, -1, -2, 1]
    assert args[8:] == (h, w, G, R, 3, 1, 1, 5, 1, 8, 8, wfd._ring_rows(w))
