"""The port's encoder is a function of its input, config and seed on a card,
as the JAX package's is, and the last CLI gaps against the JAX package are
closed. On the CPU:

  - replicate_pad (coolchic_tpu_torch/ops/convs.py) against torch's
    F.pad(mode="replicate") and the JAX package's replicate_pad: forward
    exact; backward exact on integer-valued cotangents and within 1e-6
    relative on random ones, for symmetric, asymmetric and the sharded
    synthesis's (p, p, p * top, p * bottom) pads;
  - an aten-op recorder over a short run of every path that trains (the
    n = 1 I step, P and B steps with references, a G = 4 batched window,
    a 2-shard spatial step on a mesh naming the CPU twice, the serial
    Wasserstein trainer; chip_smoke.training_paths at small crops) finds
    none of the ops that have no deterministic CUDA implementation at
    torch's defaults; the recorder itself flags each of those ops;
  - importing the port sets cuDNN deterministic, benchmark off and TF32
    off, and leaves torch.use_deterministic_algorithms to the caller;
  - the decode CLI takes --verbosity, samples/getcodingstruct takes
    --raw_coding_struct, and COOLCHIC_VGG16_NPZ reaches the Wasserstein
    loss of the encode paths (PhaseFns.wasserstein_fn) as it reaches
    JAX's: within 1e-5 of JAX's loss with the same .npz, and not the
    default loss.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from coolchic_tpu.ops.convs import replicate_pad as j_replicate_pad
from coolchic_tpu.train import wasserstein as JW
from coolchic_tpu_torch import cc_decode
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.models.frame import FrameConfig, frame_cr_grids, frame_encoder_init
from coolchic_tpu_torch.ops.convs import replicate_pad
from coolchic_tpu_torch.samples import getcodingstruct
from coolchic_tpu_torch.train import wasserstein as PW
from coolchic_tpu_torch.train.params import tree_map
from coolchic_tpu_torch.train.train import PhaseFns
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")

# (left, right, top, bottom): symmetric, asymmetric, one side only, and the
# sharded synthesis's (p, p, p * top, p * bottom) with an interior side
PADS = [(1, 1, 1, 1), (3, 3, 3, 3), (0, 2, 3, 1), (2, 0, 0, 1), (0, 0, 2, 0),
        (1, 1, 1, 0), (1, 1, 0, 1), (2, 2, 0, 0)]

# aten ops with no deterministic CUDA implementation at torch's defaults
# (torch.use_deterministic_algorithms' docstring, the CUDA entries):
# replication and reflection pads and interpolate's resamplers differentiated,
# scatter_add (gather's backward), index_add (index_select's backward),
# index_put (advanced indexing's backward), put_, cumsum, and the rest of
# that list that a codec could reach
LISTED = re.compile(
    r"aten\.(replication_pad\dd_backward|reflection_pad\dd_backward|upsample_\w+_backward"
    r"|grid_sampler_\w+_backward|scatter_add_?|scatter_reduce_?|index_add_?|index_put_?"
    r"|_index_put_impl_|index_copy_?|put_?|embedding_dense_backward|_embedding_bag\w*"
    r"|histc|bincount|median|nll_loss\w*|adaptive_\w+_pool\dd\w*|max_unpool\dd"
    r"|fractional_max_pool\w+|avg_pool3d_backward|max_pool3d_with_indices_backward"
    r"|_ctc_loss\w*)\b")


class OpRecorder(TorchDispatchMode):
    """Every aten op called under it, by name; `gather` on an input that
    requires grad is recorded as `aten.gather[grad]`, `cumsum` on a float
    as `aten.cumsum[float]`."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("aten.gather") and args[0].requires_grad:
            name = "aten.gather[grad]"
        if name.startswith("aten.cumsum") and args[0].is_floating_point():
            name = "aten.cumsum[float]"
        self.ops.add(name)
        return func(*args, **(kwargs or {}))


def listed(ops) -> list:
    return sorted(o for o in ops if LISTED.match(o) or o.endswith(("[grad]", "[float]")))


@pytest.mark.parametrize("pad", PADS, ids=[str(p) for p in PADS])
def test_replicate_pad_matches_torch_and_jax(pad):
    rng = np.random.default_rng(sum(pad))
    x = rng.normal(size=(2, 3, 5, 7)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    got = replicate_pad(xt, pad)
    ref = F.pad(torch.tensor(x), pad, mode="replicate")
    j_out, j_vjp = jax.vjp(lambda a: j_replicate_pad(a, pad), jnp.asarray(x))
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(j_out))
    for cot in (rng.integers(-8, 9, size=got.shape).astype(np.float32),
                rng.normal(size=got.shape).astype(np.float32)):
        g, = torch.autograd.grad(got, xt, torch.tensor(cot), retain_graph=True)
        j_g = np.asarray(j_vjp(jnp.asarray(cot))[0])
        xr = torch.tensor(x, requires_grad=True)
        t_g, = torch.autograd.grad(F.pad(xr, pad, mode="replicate"), xr, torch.tensor(cot))
        if np.array_equal(cot, np.round(cot)):
            np.testing.assert_array_equal(g.numpy(), j_g)
            np.testing.assert_array_equal(g.numpy(), t_g.numpy())
        else:
            scale = np.abs(j_g).max()
            assert np.abs(g.numpy() - j_g).max() <= 1e-6 * scale
            assert np.abs(g.numpy() - t_g.numpy()).max() <= 1e-6 * scale


def test_recorder_flags_the_listed_ops():
    """The recorder sees each kind of op it is there to find: the
    replicate pad and the interpolate resamplers differentiated, advanced
    indexing's backward, index_select's, gather with grad, a float
    cumsum."""
    x = torch.randn(1, 2, 4, 6, requires_grad=True)
    idx = torch.tensor([0, 2, 2, 3])
    cases = {
        "replication_pad2d_backward": lambda: F.pad(x, (1, 1, 1, 1), mode="replicate"),
        "reflection_pad2d_backward": lambda: F.pad(x, (1, 1, 1, 1), mode="reflect"),
        "upsample_bilinear2d_backward": lambda: F.interpolate(x, scale_factor=2.0,
                                                              mode="bilinear"),
        "index_put": lambda: x[..., idx, :],
        "index_add": lambda: torch.index_select(x, 2, idx),
        "gather[grad]": lambda: torch.gather(x, 3, torch.zeros_like(x, dtype=torch.long)),
        "cumsum[float]": lambda: torch.cumsum(x, 3),
    }
    for name, fn in cases.items():
        with OpRecorder() as rec:
            fn().square().sum().backward()
        assert any(name in o for o in listed(rec.ops)), (name, sorted(rec.ops))


def _path_inputs():
    data = np.asarray(load_frame_data_from_file(IMG).data, np.float32)   # [1, 3, 128, 192]
    images = np.concatenate([data[:, :, 16 * i:16 * i + 32, 24 * i:24 * i + 48]
                             for i in range(4)])
    return images, np.ascontiguousarray(data[:, :, :64, :96])


PATHS = ["I", "P", "B", "batched window", "spatial", "wasserstein"]


@pytest.mark.parametrize("k", range(len(PATHS)), ids=PATHS)
def test_training_path_calls_no_listed_op(k):
    """One short run (SOAP seeding and two windows of one step) of each path
    that trains, through its own entry point, on 32x48 crops of kodim15
    (the 2-shard step on a 64x96 crop): no op of LISTED is called, and the
    run ends on finite parameters."""
    images, big = _path_inputs()
    name, fn = list(chip_smoke.training_paths(torch.device("cpu"), images, big).items())[k]
    with OpRecorder() as rec:
        out = fn()
    assert len(rec.ops) > 20, name
    assert listed(rec.ops) == [], (name, listed(rec.ops))
    assert out and all(bool(torch.isfinite(t).all()) for t in out), name


_POLICY = r"""
import json, torch
import coolchic_tpu_torch
print(json.dumps({"deterministic": torch.backends.cudnn.deterministic,
                  "benchmark": torch.backends.cudnn.benchmark,
                  "allow_tf32": torch.backends.cudnn.allow_tf32,
                  "process_wide": torch.are_deterministic_algorithms_enabled()}))
"""


def test_import_sets_the_cudnn_policy():
    out = subprocess.run([sys.executable, "-c", _POLICY], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"deterministic": True, "benchmark": False, "allow_tf32": False,
                   "process_wide": False}


@pytest.mark.parametrize("argv,verbosity", [([], 0), (["--verbosity", "2"], 2)])
def test_cc_decode_takes_verbosity(monkeypatch, tmp_path, argv, verbosity):
    """--verbosity (int, default 0) is parsed and passed on to decode_video,
    as the JAX CLI (cc_decode.py) does."""
    from coolchic_tpu_torch.bitstream import decode

    seen = {}
    monkeypatch.setattr(decode, "decode_video", lambda *a, **kw: seen.update(kw))
    assert cc_decode.main(["-i", "x.cool", "-o", str(tmp_path / "d.ppm"), "--device", "cpu",
                           *argv]) == 0
    assert seen["verbosity"] == verbosity


def test_decode_video_takes_verbosity(tmp_path):
    """A real decode of a repo bitstream with verbosity set, on the CPU."""
    from coolchic_tpu_torch.bitstream.decode import decode_video

    f = sorted((REPO / "results/round5/kodak").glob("*.cool"))[0]
    frames = decode_video(str(f), device="cpu", verbosity=1)
    assert list(frames) == ["0"] and frames["0"].img_size == (512, 768)


def test_getcodingstruct_takes_raw_coding_struct(capsys):
    argv = ["--n_frames", "9", "--intra_pos", "0", "--p_pos", "-1", "--raw_coding_struct"]
    assert getcodingstruct.main(argv) == 0
    port = capsys.readouterr().out
    jax_out = subprocess.run([sys.executable, "samples/getcodingstruct.py", *argv], cwd=REPO,
                             check=True, capture_output=True, text=True, timeout=120).stdout
    assert port == jax_out and port.startswith("coding_order\tdisplay_order")


def test_vgg16_npz_reaches_the_encode_paths(tmp_path, monkeypatch):
    """COOLCHIC_VGG16_NPZ (an .npz of He-init weights scaled by 1.5) read by
    PhaseFns.wasserstein_fn, the loss every encode path trains with, equals
    JAX's Wasserstein loss with the same .npz within 1e-5, and differs from
    the default loss."""
    size = (32, 48)
    data = np.asarray(load_frame_data_from_file(IMG).data, np.float32)
    target = data[..., :size[0], :size[1]]
    decoded = np.clip(target + np.random.default_rng(0).normal(0, 0.05, target.shape),
                      0, 1).astype(np.float32)
    cfg = coolchic_config_from_args(intra_operating_points()["lop"], size, tune="wasserstein")
    fcfg = FrameConfig(coolchic_cfg={"residue": cfg})
    like = tree_map(lambda x: x[None], frame_encoder_init(torch.Generator().manual_seed(0),
                                                          fcfg))

    def port_loss():
        fns = PhaseFns(fcfg, like, "gaussian", "softround", chip_smoke.WASSERSTEIN_WEIGHTS,
                       (0.95, 0.95), (0.9, 0.999), 10, cr=frame_cr_grids(fcfg))
        return float(fns.wasserstein_fn(torch.tensor(target))(torch.tensor(decoded))[0])

    default = port_loss()
    npz = str(tmp_path / "vgg16.npz")
    np.savez(npz, **{k: 1.5 * v for k, v in PW._he_init_weights().items()})
    monkeypatch.setenv("COOLCHIC_VGG16_NPZ", npz)
    JW._load_vgg_weights.cache_clear()
    try:
        j_loss = float(JW.make_wasserstein_fn(jnp.asarray(target))(jnp.asarray(decoded)))
    finally:
        JW._load_vgg_weights.cache_clear()
    p_loss = port_loss()
    assert abs(p_loss - j_loss) <= 1e-5 * abs(j_loss), (p_loss, j_loss)
    assert abs(p_loss - default) > 1e-3 * abs(default), (p_loss, default)
