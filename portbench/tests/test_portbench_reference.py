"""The benchmark's plain references against the port, on the CPU, and the
yardstick's arithmetic."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import inputs, yardstick
from portbench.reference import decode as rdec
from portbench.reference.train import Soap

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name,macs", [("hop", 1976), ("lop", 520)])
def test_mac_per_pixel(name, macs):
    from coolchic_tpu_torch.utils.complexity import total_mac_per_pixel
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args

    c = yardstick.load_config(name)
    got = yardstick.mac_per_pixel(yardstick.coolchic_config(c["operating_point"],
                                                            tuple(c["image_size"])))
    assert round(got) == macs
    assert got == total_mac_per_pixel(coolchic_config_from_args(c["operating_point"],
                                                                tuple(c["image_size"])))


def test_kernel_bound_is_chip_smokes():
    # 8 grids of 512x768, hop's ARM (14 + 6 wide, 2 hidden layers): bound by operations
    s, by, work = yardstick.kernel_bound(512, 768, 8, 0, 6, 20, 2)
    assert by == "operations" and work["serial_wavefronts"] == 3834
    assert s == pytest.approx(0.102e-3, rel=0.01)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("coolchic_tpu", "coolchic_tpu_torch", "jax")
                           for n in names), path
    code = ("import sys; import portbench.reference.decode, portbench.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'coolchic_tpu', 'coolchic_tpu_torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_decode_against_the_port():
    from coolchic_tpu_torch.bitstream.codec import decode_coolchic_tpu_host
    from coolchic_tpu_torch.bitstream.decode import _finish_frame
    from coolchic_tpu_torch.bitstream.headers import (TPU_PROFILE_MAGIC, CoolChicHeader,
                                                      FrameHeader, VideoHeader)

    torch.set_num_threads(2)
    data = (inputs.DATA / inputs.pool("hop")[0]).read_bytes()
    parsed = rdec.parse(data)
    grids = rdec.decode_latents([parsed])[0]
    frame = rdec.finish(rdec.float_tail(parsed, grids, "cpu"), 8)
    rest = data[len(TPU_PROFILE_MAGIC):]
    _, rest = VideoHeader.read(rest)
    _, rest = FrameHeader.read(rest)
    ch, rest = CoolChicHeader.read(rest)
    raw, port_grids = decode_coolchic_tpu_host(
        ch, rest[:ch.nn_n_bytes], rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent],
        device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(grids, port_grids))
    codes = np.abs(np.round(frame * 255) - np.round(_finish_frame(raw, 8, "rgb").data * 255))
    assert codes.max() <= 1 and (codes > 0).mean() < 1e-4


@pytest.mark.parametrize("shape,weight", [((20, 20), True), ((48, 7, 1, 1), True),
                                          ((3, 3, 3, 3), True), ((20,), True),
                                          ((64, 96), False)])
def test_reference_soap_against_the_port(shape, weight):
    from coolchic_tpu_torch.train.soap import (SoapHyperParams, soap_init_from_grad_leaf,
                                               soap_init_leaf, soap_step_leaf)

    g = torch.Generator().manual_seed(0)
    p = torch.randn(shape, generator=g)
    if weight:
        hp = SoapHyperParams(b1=0.95, b2=0.95, weight_decay=0.01, precondition_frequency=10,
                             max_precond_dim=256)
        mine = Soap(p, 0.95, 0.95, 0.01, 256)
    else:
        hp = SoapHyperParams(b1=0.9, b2=0.999, weight_decay=0.0, precondition_frequency=1,
                             max_precond_dim=0)
        mine = Soap(p, 0.9, 0.999, 0.0, 0)
    state = soap_init_leaf(p[None], hp)
    g0 = torch.randn(shape, generator=g)
    if weight:
        state = soap_init_from_grad_leaf(g0[None], state, hp)
        mine.seed(g0)
    theirs, ours = p[None].clone(), p.clone()
    for k in range(12):                       # the refresh after step 10 included
        grad = torch.randn(shape, generator=g)
        refresh = weight and (k + 1) % 10 == 0
        theirs, state = soap_step_leaf(grad[None], state, theirs, torch.tensor(0.01), hp,
                                       refresh=refresh)
        ours = mine.update(ours, grad, 0.01, refresh=refresh)
    assert float((theirs[0] - ours).abs().max()) < 1e-5
