"""--tune wasserstein in the port against the JAX package: the Wasserstein
distortion (train/wasserstein.py) and common randomness in the forward
(models/coolchic.py); tests/test_torch_serial_train.py holds the training
step and the serial trainer that the encoder runs for such configs.

  - the He-init VGG16 weights are identical, and an .npz of weights loads;
  - VGG16 features, wasserstein_distortion and its gradient with respect
    to the decoded image: within 1e-4 relative (of each array's largest
    magnitude);
  - synthesis_input (with no_cr / only_cr) and coolchic_forward with
    flag_common_randomness, eval and training (JAX's noise injected):
    within 1e-5 (raw output; the total rate 1e-5 relative);
  - the CLI with --tune wasserstein (a 32x48 crop of kodim15, lop, debug
    recipe, RDOQ on: common randomness, the serial trainer, the Wasserstein
    loss in training and in the NN quantization's trial evaluations) exits
    0 after its own decode-back check; the JAX package's decoder reads the
    file; the logs parse. The crop is small because every one of the NN
    quantization's ~640 trials runs VGG16 on the CPU, and lambda is 1e-4
    so that the headers (~80 bytes) stay inside the CLI's 20 % rate check
    at that size. The CLI refuses --tune wasserstein for .yuv input, as
    the JAX CLI does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.bitstream.decode import decode_video as j_decode_video
from coolchic_tpu.io.io import load_frame_data_from_file
from coolchic_tpu.models.coolchic import coolchic_forward as j_cc_forward
from coolchic_tpu.models.coolchic import synthesis_input as j_synthesis_input
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_cr_grids as j_cr_grids
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.train import wasserstein as JW
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch import cc_encode
from coolchic_tpu_torch.bitstream.decode import decode_video as p_decode_video
from coolchic_tpu_torch.models.coolchic import coolchic_forward as p_cc_forward
from coolchic_tpu_torch.models.coolchic import make_cr_grids
from coolchic_tpu_torch.models.coolchic import synthesis_input as p_synthesis_input
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.train import wasserstein as PW
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import intra_operating_points

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")


def _close(p, j, rel):
    p, j = np.asarray(p, np.float64), np.asarray(j, np.float64)
    assert p.shape == j.shape
    assert np.abs(p - j).max() <= rel * np.abs(j).max(), np.abs(p - j).max() / np.abs(j).max()


def test_vgg_weights_identical(tmp_path):
    j, p = JW._he_init_weights(), PW._he_init_weights()
    assert list(p) == list(j)
    for k in j:
        np.testing.assert_array_equal(p[k], j[k])
    # the optional .npz path (torchvision layout) loads the same weights
    path = str(tmp_path / "vgg16.npz")
    np.savez(path, **{k: 2 * v for k, v in j.items()})
    loaded = PW.load_vgg_weights(torch.device("cpu"), path)
    for k in j:
        np.testing.assert_array_equal(loaded[k].numpy(), 2 * j[k])


def test_features_and_distortion_match_jax():
    rng = np.random.default_rng(0)
    x = rng.random((1, 3, 48, 64), dtype=np.float32)
    target = rng.random((1, 3, 48, 64), dtype=np.float32)
    j_feats = jax.jit(JW.vgg16_features)(jnp.asarray(x))
    p_feats = PW.vgg16_features(torch.tensor(x))
    for jf, pf in zip(j_feats, p_feats):
        _close(pf.numpy().reshape(jf.shape), jf, 1e-4)
    j_fn = JW.make_wasserstein_fn(jnp.asarray(target))
    j_val, j_grad = jax.jit(jax.value_and_grad(lambda v: j_fn(v)))(jnp.asarray(x))
    p_fn = PW.make_wasserstein_fn(torch.tensor(target))
    xt = torch.tensor(x, requires_grad=True)
    p_val = p_fn(xt)
    (p_grad,) = torch.autograd.grad(p_val.sum(), xt)
    assert p_val.shape == (1,)
    _close(p_val.detach().numpy(), np.asarray(j_val)[None], 1e-4)
    _close(p_grad.numpy(), j_grad, 1e-4)
    # a batch of two decoded images against one target: one value each
    two = PW.make_wasserstein_fn(torch.tensor(target))(torch.tensor(np.concatenate([x, target])))
    two, one = two.detach().numpy(), float(p_val.detach())
    assert two[1] <= 1e-9 * one and abs(two[0] - one) <= 1e-6 * one


def _cr_setup(size=(64, 96), seed=0):
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS["lop"], size, tune="wasserstein")
    pcfg = p_cfg_from_args(intra_operating_points()["lop"], size, tune="wasserstein")
    assert repr(jcfg) == repr(pcfg) and pcfg.flag_common_randomness
    jf, pf = JFrameConfig(coolchic_cfg={"residue": jcfg}), FrameConfig(coolchic_cfg={"residue": pcfg})
    params = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(seed), jf))
    rng = np.random.default_rng(seed)
    cc = params["residue"]
    cc["latents"] = [rng.normal(0, 2.0, x.shape).astype(np.float32) / jcfg.encoder_gain
                     for x in cc["latents"]]
    for lay in cc["arm"]["layers"] + cc["synthesis"]["layers"]:
        lay["weight"] = lay["weight"] + rng.normal(0, 0.05, lay["weight"].shape).astype(np.float32)
        lay["bias"] = lay["bias"] + rng.normal(0, 0.05, lay["bias"].shape).astype(np.float32)
    target = np.asarray(load_frame_data_from_file(IMG).data, np.float32)[..., :size[0], :size[1]]
    return jcfg, pcfg, jf, pf, params, target


@pytest.mark.parametrize("no_cr,only_cr", [(False, False), (True, False), (False, True)])
def test_synthesis_input_matches_jax(no_cr, only_cr):
    jcfg, pcfg, *_ = _cr_setup()
    j_cr = j_cr_grids(JFrameConfig(coolchic_cfg={"residue": jcfg}))["residue"]
    p_cr = make_cr_grids(pcfg)
    for a, b in zip(j_cr, p_cr):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    dense = np.random.default_rng(1).normal(size=(7, 64, 96)).astype(np.float32)
    j_in = j_synthesis_input(jcfg, jnp.asarray(dense), j_cr, no_cr=no_cr, only_cr=only_cr)
    p_in = p_synthesis_input(pcfg, torch.tensor(dense)[None], p_cr, no_cr=no_cr,
                             only_cr=only_cr)
    assert p_in.shape == (1, 14, 64, 96)
    np.testing.assert_allclose(p_in.numpy(), np.asarray(j_in), rtol=0, atol=1e-5)


@pytest.mark.parametrize("training", [False, True])
def test_cr_forward_matches_jax(training):
    jcfg, pcfg, _, _, params, _ = _cr_setup()
    cc = params["residue"]
    key = jax.random.PRNGKey(7)
    kw = dict(quantizer_noise_type="gaussian", soft_round_temperature=0.3,
              noise_parameter=0.22) if training else {}
    # jax_noise replays frame_encoder_forward's draws: one split for the
    # cool-chic, then one per grid
    j_out = jax.jit(lambda p, k, cr: j_cc_forward(p, jcfg, key=k, training=training, cr=cr,
                                                  **kw))(
        jax.tree_util.tree_map(jnp.asarray, cc), jax.random.split(key)[1],
        j_cr_grids(JFrameConfig(coolchic_cfg={"residue": jcfg}))["residue"])
    noise = None
    if training:
        from tests.test_torch_encode_forward import jax_noise

        noise = [torch.tensor(n)[None] for n in jax_noise(key, jcfg)]
    p_out = p_cc_forward(tree_from_numpy(jax.tree_util.tree_map(lambda x: x[None], cc), "cpu"),
                         pcfg, noise=noise, training=training, soft_round_temperature=0.3,
                         cr=make_cr_grids(pcfg))
    np.testing.assert_allclose(p_out.raw_out[0].detach().numpy(), np.asarray(j_out.raw_out)[0],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(p_out.rate.sum()), float(j_out.rate.sum()), rtol=1e-5)


def test_cli_wasserstein_decodes_back(tmp_path):
    from tests.test_torch_encode_e2e import _close_8bit, _crop_ppm, check_workdir_logs

    src = _crop_ppm(str(tmp_path / "crop.ppm"), h=32, w=48)
    out, wd = str(tmp_path / "out.cool"), tmp_path / "wd"
    rc = cc_encode.main(["-i", src, "-o", out, "--workdir", str(wd), "--recipe", "debug",
                         "--dec_cfg_residue", "lop", "--lmbda", "1e-4", "--tune", "wasserstein",
                         "--device", "cpu"])
    assert rc == 0
    assert "flag_common_randomness=True" in (wd / "archi.txt").read_text()
    detailed = check_workdir_logs(wd)
    # the serial trainer ran the main phases and counts its time
    assert float(detailed["time_sec"]) > 0
    p_dec = p_decode_video(out, device="cpu")["0"].data
    _close_8bit(p_dec, j_decode_video(out)["0"].data)


def test_cli_refuses_wasserstein_for_yuv(tmp_path):
    yuv = str(REPO / "tests/data/D-BQSquare-3frames_224x128_60p_yuv420_8b.yuv")
    assert cc_encode.main(["-i", yuv, "-o", str(tmp_path / "o.cool"), "--workdir",
                           str(tmp_path), "--tune", "wasserstein", "--device", "cpu"]) == 1
    assert not (tmp_path / "o.cool").exists()
