"""The spatial (H) sharding of one image (parallel/spatial.py, the sharded
forward of models/coolchic.py) against the JAX package's GSPMD sharding on
its 8-virtual-device CPU mesh (tests/conftest.py), on a 128x192 lop frame:

  - the port's shard plan equals the placements JAX's shard_spatial gives
    (each leaf's PartitionSpec), for the params and the target;
  - from the same params (carried by models/params.py), the port's
    8-shard evaluate against JAX's make_spatial_train evaluate: loss within
    1e-5 relative; make_spatial_synthesis against JAX's sharded decode:
    within 2e-5;
  - one training step, the port sharded over 8 against the port whole,
    the same noise: each leaf's gradient within 1e-5 in L2 relative to the
    whole step's;
  - three steps of a window from JAX's carried state with JAX's noise
    injected (tests/test_torch_train_window.py:carried_steps), the port's
    steps sharded over 8 (a 64x96 crop): every coordinate within 5e-2 * lr
    of JAX's after each step.

The port's mesh names the CPU 8 times: the copies between shards are then
no-ops, and what is tested is the decomposition (slabs, halos, the rows'
reassembly), which is where a card-to-card run could differ only by
where the slabs live.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.parallel.batch import make_spatial_synthesis as j_spatial_synthesis
from coolchic_tpu.parallel.batch import phase_key as j_phase_key
from coolchic_tpu.parallel.spatial import make_spatial_train as j_spatial_train
from coolchic_tpu.parallel.spatial import shard_spatial as j_shard_spatial
from coolchic_tpu.parallel.spatial import shard_target as j_shard_target
from coolchic_tpu.train.presets import TrainerPhase as JPhase
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.parallel.batch import make_mesh, make_spatial_synthesis, phase_key
from coolchic_tpu_torch.parallel.spatial import make_spatial_train, shard_spatial, shard_target
from coolchic_tpu_torch.train.params import tree_flatten_with_path, tree_leaves, tree_map
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.train import PhaseFns, TorchNoise
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import intra_operating_points
from tests.test_torch_train_window import carried_steps

torch.set_num_threads(2)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-virtual-device mesh")
H, W = 128, 192
PHASE = dict(lmbda=1e-3, max_itr=8, freq_valid=8, lr=1e-2, quantizer_noise_type="gaussian",
             quantizer_type="softround")


def _image(h, w, seed=0):
    """Smooth structure and texture in [0, 1] (tests/test_spatial.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.25 * np.sin(yy / 37.0) * np.cos(xx / 53.0)
    tex = 0.08 * rng.standard_normal((3, h, w)).astype(np.float32)
    return np.clip(base[None] + tex, 0.0, 1.0)[None]


def _setup():
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS["lop"], (H, W))
    pcfg = p_cfg_from_args(intra_operating_points()["lop"], (H, W))
    jf, pf = JFrameConfig(coolchic_cfg={"residue": jcfg}), FrameConfig(
        coolchic_cfg={"residue": pcfg})
    params = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(0), jf))
    # latents off zero, so that every grid's rate and every synthesis row
    # carries signal
    rng = np.random.default_rng(1)
    params["residue"]["latents"] = [rng.normal(0, 1.5, x.shape).astype(np.float32)
                                    / jcfg.encoder_gain for x in params["residue"]["latents"]]
    return jf, pf, params, _image(H, W)


def _j_mesh():
    return JMesh(np.array(jax.devices()[:8]), ("space",))


def _p_mesh():
    return make_mesh(8, space=8, device="cpu")


def test_shard_plan_matches_jax():
    jf, _, params, target = _setup()
    placed = j_shard_spatial(jax.tree_util.tree_map(jnp.asarray, params), _j_mesh())
    j_plan = [(jax.tree_util.keystr(path), tuple(x.sharding.spec))
              for path, x in jax.tree_util.tree_flatten_with_path(placed)[0]]
    plan = shard_spatial(params, _p_mesh())
    assert plan == j_plan
    assert sum(spec != () for _, spec in plan) == 3   # grids of 128, 64 and 32 rows
    assert shard_target(target, _p_mesh()) == tuple(
        j_shard_target(jnp.asarray(target), _j_mesh()).sharding.spec)


def test_sharded_eval_and_decode_match_jax():
    jf, pf, params, target = _setup()
    j_phase = JPhase(**PHASE)
    _, j_eval, j_prep = j_spatial_train(jf, j_phase_key(j_phase), _j_mesh(), freq_valid=3)
    jp, _, jt, _ = j_prep(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(target))
    j_loss = float(j_eval(jp, jt).loss)
    _, p_eval, p_prep = make_spatial_train(pf, phase_key(TrainerPhase(**PHASE)), _p_mesh(),
                                           freq_valid=3)
    pp, _, pt, _ = p_prep(tree_from_numpy(params, "cpu"), target)
    p_loss = float(p_eval(pp, pt).loss[0])
    assert abs(p_loss - j_loss) <= 1e-5 * abs(j_loss), (p_loss, j_loss)

    j_dec = np.asarray(j_spatial_synthesis(jf, _j_mesh())(
        jax.tree_util.tree_map(jnp.asarray, params)))
    p_dec = make_spatial_synthesis(pf, _p_mesh())(tree_from_numpy(params, "cpu")).numpy()
    assert p_dec.shape == j_dec.shape
    np.testing.assert_allclose(p_dec, j_dec, atol=2e-5)


def test_sharded_step_matches_whole():
    _, pf, params, target = _setup()
    like = tree_from_numpy(tree_map(lambda x: np.asarray(x)[None], params), "cpu")
    noise = TorchNoise(torch.Generator().manual_seed(3))(
        "step", pf, 1, "gaussian", torch.tensor([0.2]), True)
    grads = {}
    for name, mesh in (("whole", None), ("sharded", _p_mesh())):
        fns = PhaseFns(pf, like, "gaussian", "softround", {"mse": 1.0}, (0.95, 0.95),
                       (0.9, 0.999), 10, mesh=mesh)
        grads[name] = fns.grads(tree_leaves(like), noise, 0.3, torch.tensor(target),
                                torch.tensor([1e-3]))
    worst = 0.0
    for (path, _), a, b in zip(tree_flatten_with_path(like), grads["sharded"],
                               grads["whole"]):
        if b is None or float(b.abs().max()) == 0.0:
            continue
        worst = max(worst, float((a - b).norm() / b.norm()))
    assert worst <= 1e-5, worst


def test_sharded_window_from_carried_jax_state():
    # the bar, 5e-2 * LR per coordinate after each step, is carried_steps'
    carried_steps(1, [1e-3], [0.2], mesh=_p_mesh(), n_steps=3)
