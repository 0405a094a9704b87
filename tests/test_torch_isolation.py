"""The PyTorch port stands alone: no module of coolchic_tpu_torch loads JAX or
any module of the JAX package, it pins the full-f32 float policy, and its
entry points refuse to fall back to the CPU when a card is asked for."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import coolchic_tpu_torch as pkg
names = []
for m in pkgutil.walk_packages(pkg.__path__, prefix="coolchic_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
import torch
leaked = sorted(n for n in sys.modules
                if n == "jax" or n.startswith("jax.") or n == "coolchic_tpu"
                or n.startswith("coolchic_tpu."))
print(json.dumps({"modules": names, "leaked": leaked,
                  "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                  "matmul_precision": torch.get_float32_matmul_precision()}))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "coolchic_tpu_torch.ops.wavefront_decode" in res["modules"]
    assert "coolchic_tpu_torch.bitstream.device_decode" in res["modules"]
    assert res["leaked"] == []
    assert res["cudnn_tf32"] is False
    assert res["matmul_precision"] == "highest"


@pytest.mark.parametrize("entry", ["decode_video", "decode_images", "resolve_device"])
def test_default_device_refuses_cpu_fallback(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from coolchic_tpu_torch.bitstream.decode import decode_images, decode_video
    from coolchic_tpu_torch.core.device import resolve_device

    ref_file = str(REPO / "results/round4/h2h_kodim15_v3/kodim15_p012_l0.02.cool")
    call = {"decode_video": lambda: decode_video(ref_file),
            "decode_images": lambda: decode_images([]),
            "resolve_device": lambda: resolve_device("cuda")}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
