"""The port's P/B training against the JAX package's, on a 64x96 crop of
BQSquare at lop / lop with JAX's noise draws injected: the main phase's
step with the references riding the batch axis (from a carried state, at
tests/test_torch_train_step.py's per-step bar), the serial train() with
references, and the motion pretraining's trainer on the "flow" frame (an
I-type frame whose target is the estimated flow, train/video.py:
guided_motion_pretraining), those two at that file's whole-phase bar
(best loss within 1e-2 relative, both below the start, every coordinate
within 4 * lr * steps).
Also: the inter and debug presets, motion pretraining included, equal
JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.models.flow import estimate_flow as j_flow
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.train.presets import TrainerPhase as JPhase
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.train import _make_fns
from coolchic_tpu.train.train import init_opt_state as j_init_opt_state
from coolchic_tpu.train.train import seed_opt_state as j_seed_opt_state
from coolchic_tpu.train.train import train as j_train
from coolchic_tpu.utils.parsecli import substitute_x_channels
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.params import soap_state_from_jax, tree_from_numpy
from coolchic_tpu_torch.train.presets import TrainerPhase as PPhase
from coolchic_tpu_torch.train.train import EncoderMonitor as PMonitor
from coolchic_tpu_torch.train.train import PhaseFns
from coolchic_tpu_torch.train.train import train as p_train
from coolchic_tpu_torch.train.params import tree_leaves
from tests.test_torch_inter_forward import inter_setup
from tests.test_torch_train_step import JaxNoise, _check_fresh, _max_abs_diff, _stack_np

torch.set_num_threads(2)
CROP = (16, 40, 64, 96)
N_STEPS, LR = 11, 1e-2
MAIN = dict(lmbda=1e-3, lr=LR, max_itr=N_STEPS, freq_valid=N_STEPS, patience=100000,
            schedule_lr=True, quantizer_type="softround", quantizer_noise_type="gaussian",
            softround_temperature=(0.3, 0.1), noise_parameter=(0.25, 0.1),
            precondition_frequency_model=10)


@pytest.mark.parametrize("frame_type", ["P", "B"])
def test_step_with_refs_from_carried_state(frame_type):
    """The main phase's step (PhaseFns.step, which _batched_phase's window
    runs) with the references riding the batch axis: JAX seeds SOAP and
    trains 12 steps, then its parameters and SOAP state are carried into
    the port, which takes step 13 with the same noise; every coordinate
    within 5e-2 * lr of JAX's step 13 (tests/test_torch_train_step.py's
    carried-state bar)."""
    jf, pf, params, target, refs = inter_setup(frame_type, crop=CROP)
    ph = JPhase(**MAIN)
    fns = _make_fns(jf, ph.quantizer_noise_type, ph.quantizer_type, (("mse", 1.0),),
                    ph.lmbda, tuple(ph.betas_model), tuple(ph.betas_latent),
                    ph.precondition_frequency_model, N_STEPS, True)
    j_tgt = {k: jnp.asarray(v) for k, v in target.items()}
    j_refs = [jnp.asarray(r) for r in refs]
    temp, noise = 0.3, 0.25
    p = jax.tree_util.tree_map(jnp.asarray, params)
    key = jax.random.PRNGKey(21)
    opt = j_init_opt_state(p, fns["hp_weight"], fns["hp_latent"])
    key, sub = jax.random.split(key)
    g0 = fns["grad_fn"](p, sub, jnp.float32(temp), jnp.float32(noise), j_tgt, j_refs, None)
    opt = j_seed_opt_state(p, opt, g0, fns["hp_weight"])

    def j_step(p, opt, key):   # a window of length 1: one plain step
        return fns["train_window"](p, opt, key, jnp.float32(LR), jnp.float32(temp),
                                   jnp.float32(noise), j_tgt, j_refs, None, length=1)

    for _ in range(12):
        p, opt, key = j_step(p, opt, key)
    treedef = jax.tree_util.tree_structure(p)
    leaves = tree_leaves(tree_from_numpy(_stack_np([p]), "cpu"))
    states = [soap_state_from_jax(None if s is None else _stack_np([s]), "cpu")
              for s in treedef.flatten_up_to(opt)]
    pfns = PhaseFns(pf, tree_from_numpy(_stack_np([p]), "cpu"), ph.quantizer_noise_type,
                    ph.quantizer_type, ph.dist_weight, tuple(ph.betas_model),
                    tuple(ph.betas_latent), ph.precondition_frequency_model)
    drawn = JaxNoise([key])("step", pf, 1, ph.quantizer_noise_type, torch.full((1,), noise),
                            pfns.need_noise)
    leaves, _ = pfns.step(leaves, states, drawn, temp, torch.tensor(LR),
                          {k: torch.tensor(v) for k, v in target.items()},
                          torch.full((1,), 1e-3), refresh=False,
                          refs=[torch.tensor(r) for r in refs])
    p, _, _ = j_step(p, opt, key)
    worst = _max_abs_diff(leaves, _stack_np([p]))
    assert worst <= 5e-2 * LR, worst


def test_serial_train_with_refs():
    jf, pf, params, target, refs = inter_setup("B", crop=CROP, seed=1)
    key = jax.random.PRNGKey(5)
    j_best = j_train(jax.tree_util.tree_map(jnp.asarray, params), jf,
                     {k: jnp.asarray(v) for k, v in target.items()}, JPhase(**MAIN),
                     refs=[jnp.asarray(r) for r in refs], key=key, monitor=JMonitor())
    key_after, seed_key = jax.random.split(key)
    tgt = {k: torch.tensor(v) for k, v in target.items()}
    refs_t = [torch.tensor(r) for r in refs]
    monitor = PMonitor()
    p_best = p_train(tree_from_numpy(params, "cpu"), pf, tgt, PPhase(**MAIN),
                     noise_source=JaxNoise([key_after], [seed_key]), refs=refs_t,
                     monitor=monitor)
    assert monitor.iterations_counter == N_STEPS
    fns = PhaseFns(pf, tree_from_numpy(_stack_np([params]), "cpu"), "none", "hardround",
                   {"mse": 1.0}, (0.95, 0.95), (0.9, 0.999), 10)

    def loss_of(tree):
        return fns.eval([torch.as_tensor(np.asarray(x))[None] for x in
                         jax.tree_util.tree_leaves(tree)], tgt, 1e-3, refs_t).loss.numpy()

    start = loss_of(params)
    _check_fresh(tree_from_numpy(_stack_np([p_best]), "cpu"), torch.tensor(loss_of(p_best)),
                 _stack_np([j_best]), loss_of(j_best), start)


def test_motion_pretraining_trainer():
    """The flow frame of guided_motion_pretraining: the B frame's two LK
    flows as a 4-channel target (out of [0, 1], renormalized by the loss),
    the motion config at encoder gain 16 with X = 4, the serial trainer of
    the debug preset's pretraining phase."""
    jf, pf, params, target, refs = inter_setup("B", crop=CROP)
    from coolchic_tpu.io.yuv import convert_420_to_444

    dense = convert_420_to_444(target)
    flows = np.concatenate([np.asarray(j_flow(dense, r)) for r in refs], axis=1)
    motion_cfg = jf.cc_cfgs["motion"]
    layers = substitute_x_channels(list(motion_cfg.layers_synthesis), flows.shape[1])
    pre = dataclasses.replace(motion_cfg, layers_synthesis=tuple(layers), encoder_gain=16)
    kw = dict(frame_type="I", frame_data_type="flow", bitdepth=8)
    jfc = JFrameConfig(coolchic_cfg={"residue": pre}, **kw)
    pfc = FrameConfig(coolchic_cfg={"residue": pre}, **kw)
    p0 = jax.tree_util.tree_map(np.asarray, j_frame_init(jax.random.PRNGKey(2), jfc))
    ph = dict(lr=1e-2, max_itr=N_STEPS, freq_valid=N_STEPS, patience=N_STEPS,
              schedule_lr=True, quantizer_type="softround", quantizer_noise_type="gaussian",
              softround_temperature=(0.3, 0.1), noise_parameter=(0.25, 0.1), lmbda=1e-3)
    key = jax.random.PRNGKey(6)
    j_best = j_train(jax.tree_util.tree_map(jnp.asarray, p0), jfc, jnp.asarray(flows),
                     JPhase(**ph), key=key, monitor=JMonitor())
    key_after, seed_key = jax.random.split(key)
    p_best = p_train(tree_from_numpy(p0, "cpu"), pfc, torch.tensor(flows), PPhase(**ph),
                     noise_source=JaxNoise([key_after], [seed_key]), monitor=PMonitor())
    fns = PhaseFns(pfc, tree_from_numpy(_stack_np([p0]), "cpu"), "none", "hardround",
                   {"mse": 1.0}, (0.95, 0.95), (0.9, 0.999), 10)

    def loss_of(tree):
        return fns.eval([torch.as_tensor(np.asarray(x))[None] for x in
                         jax.tree_util.tree_leaves(tree)], torch.tensor(flows),
                        1e-3).loss.numpy()

    _check_fresh(tree_from_numpy(_stack_np([p_best]), "cpu"), torch.tensor(loss_of(p_best)),
                 _stack_np([j_best]), loss_of(j_best), loss_of(p0))


@pytest.mark.parametrize("name", ["inter", "debug"])
@pytest.mark.parametrize("n_itr", [2000, 10000])
def test_inter_presets_match_jax(name, n_itr):
    """The inter and debug presets, motion pretraining phase included."""
    from coolchic_tpu.train.presets import AVAILABLE_PRESETS as J
    from coolchic_tpu_torch.train.presets import AVAILABLE_PRESETS as P

    kw = dict(lmbda=2e-4, start_lr=1e-2, itr_main_training=n_itr, itr_motion_pretrain=3000)
    j, p = J[name](**kw), P[name](**kw)
    assert repr(p.training_phases) == repr(j.training_phases)
    assert repr(p.warmup) == repr(j.warmup)
    assert repr(p.motion_pretrain_phase) == repr(j.motion_pretrain_phase)
