"""The port's training window and phase (train/train.py:PhaseFns.window,
parallel/encode_batch.py:_batched_phase, train/warmup.py) against the JAX
package's, with JAX's own noise draws injected into the port.

Two kinds of comparison, because a SOAP/Adam trajectory from a fresh
optimizer state is ill-conditioned:

  - From a carried state, step by step (tests/test_torch_train_window.py:
    test_window_steps_from_carried_state, on a 64x96 crop): JAX trains 12
    steps, then runs one window of
    precondition_frequency + 1 = 11 steps, which holds the QR eigenbasis
    refresh (step 10) and one plain step after it. Before each step, JAX's
    parameters and SOAP state (step, exp_avg, exp_avg_sq, GG, Q of every
    leaf) are carried into the port, which takes the same step with the
    same noise; step 11 starts from the port's own refreshed state, so the
    port's QR refresh is what it tests. At n = 1 (the main phase:
    softround, gaussian noise) and at n = 3 (three warm-up candidates:
    kumaraswamy noise, each slot its own state and noise). Tolerance: after
    every step, every coordinate of every leaf within 5e-2 * lr of JAX's (a
    twentieth of one step; f32 summation order differs in every op, and a
    latent whose Adam second moment is still small turns that into up to
    3e-2 * lr). The
    carry before each step keeps the test well conditioned: run free over
    the window, a ReLU or rounding boundary crossed on one side only grows
    a one-ulp difference to a few tenths of lr within three steps, in the
    JAX package as much as in the port.
  - From a fresh state (test_main_phase_n1, test_warmup_phase_n3): the
    whole phase as the encoder runs it, SOAP seeding from a first gradient
    at n = 1, none for the warm-up. Adam's first step is lr * sign(g) per
    coordinate, so a gradient that is rounding noise flips by 2 lr, and
    the seeding's eigh of a rank-one covariance picks an arbitrary basis
    of its null space: both packages would diverge as much from a one-ulp
    change of their own inputs. Here the best loss of each slot agrees
    within 1e-2 relative, both lower the loss from its start, and every
    coordinate stays within 4 * lr * steps of JAX's (what a sign error or
    a wrong lr scale would break).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coolchic_tpu.core.quantizer import sample_noise
from coolchic_tpu.io.io import load_frame_data_from_file
from coolchic_tpu.models.frame import FrameConfig as JFrameConfig
from coolchic_tpu.models.frame import frame_encoder_init as j_frame_init
from coolchic_tpu.parallel.encode_batch import _batched_phase as j_batched_phase
from coolchic_tpu.train.presets import TrainerPhase as JPhase
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.video import _frame_phase_key
from coolchic_tpu.train.warmup import _train_phase_batched as j_warmup_phase
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.parallel.encode_batch import _batched_phase as p_batched_phase
from coolchic_tpu_torch.train.params import tree_leaves
from coolchic_tpu_torch.train.presets import TrainerPhase as PPhase
from coolchic_tpu_torch.train.train import EncoderMonitor as PMonitor
from coolchic_tpu_torch.train.train import PhaseFns
from coolchic_tpu_torch.train.warmup import _train_phase_batched as p_warmup_phase
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args as p_cfg_from_args
from coolchic_tpu_torch.utils.parsecli import intra_operating_points

torch.set_num_threads(2)
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
N_STEPS, LR = 11, 1e-2
MAIN = dict(lmbda=1e-3, lr=LR, max_itr=N_STEPS, freq_valid=N_STEPS, patience=100000,
            schedule_lr=True, quantizer_type="softround", quantizer_noise_type="gaussian",
            softround_temperature=(0.35, 0.08), noise_parameter=(0.22, 0.15),
            precondition_frequency_model=10)
WARMUP = dict(lmbda=1e-3, max_itr=N_STEPS, freq_valid=N_STEPS)   # debug warm-up phase


class JaxNoise:
    """The port's noise source fed with JAX's draws: per slot, the key
    splits of JAX's training step (one per step, then one per cool-chic in
    turn, one per grid), JAX's sample_noise, and the seeding gradient's own
    keys."""

    def __init__(self, keys, seed_keys=None):
        self.keys = list(keys)
        self.seed_keys = seed_keys

    def __call__(self, kind, fcfg, G, noise_type, noise_parameter, need):
        if kind == "seed":
            fwd = list(self.seed_keys)
        else:
            fwd = []
            for i, k in enumerate(self.keys):
                self.keys[i], sub = jax.random.split(k)
                fwd.append(sub)
        if not need:
            return None
        out = {}
        for name, cfg in fcfg.cc_cfgs.items():
            per_grid = [[] for _ in cfg.size_per_latent]
            for i, k in enumerate(fwd):
                # frame_encoder_forward: key, sub = split(key) per cool-chic
                fwd[i], sub = jax.random.split(k)
                for j, shape in enumerate(cfg.size_per_latent):
                    sub, s = jax.random.split(sub)
                    per_grid[j].append(np.asarray(sample_noise(
                        s, shape, noise_type, jnp.float32(float(noise_parameter[i])))))
            out[name] = [torch.tensor(np.stack(x)) for x in per_grid]
        return out


def _setup(n, perturb, crop=None):
    """Frame configs, n stacked JAX-initialized params (numpy), target (the
    image's top-left crop = (h, w) when given)."""
    frame = load_frame_data_from_file(IMG)
    if crop is not None:
        frame.data = np.ascontiguousarray(np.asarray(frame.data)[:, :, :crop[0], :crop[1]])
    jcfg = j_cfg_from_args(INTRA_OPERATING_POINTS["lop"], frame.img_size)
    pcfg = p_cfg_from_args(intra_operating_points()["lop"], frame.img_size)
    jf = JFrameConfig(coolchic_cfg={"residue": jcfg})
    pf = FrameConfig(coolchic_cfg={"residue": pcfg})
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    trees = [jax.tree_util.tree_map(np.asarray, j_frame_init(k, jf)) for k in keys]
    if perturb:
        rng = np.random.default_rng(0)
        for t in trees:
            t["residue"]["latents"] = [
                rng.normal(0, 2.0, x.shape).astype(np.float32) / jcfg.encoder_gain
                for x in t["residue"]["latents"]]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    return jf, pf, stacked, np.asarray(frame.data, np.float32)


def _stack_np(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                  *trees)


def _max_abs_diff(p_tree, j_tree) -> float:
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    p_leaves = tree_leaves(p_tree)
    assert len(j_leaves) == len(p_leaves)
    worst = 0.0
    for a, b in zip(p_leaves, j_leaves):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def test_window_refresh_schedule(monkeypatch):
    """(pf - 1) plain steps then a refresh step, from the window's start,
    and no refresh in a remainder shorter than pf: JAX's train_window."""
    refreshes = []
    monkeypatch.setattr(PhaseFns, "step", lambda self, leaves, states, *a, refresh:
                        (refreshes.append(refresh), (leaves, states))[1])
    fns = PhaseFns.__new__(PhaseFns)
    fns.pf = 10
    fns.window([], [], lambda: None, 23, 0.3, torch.tensor(LR), None, None)
    assert [i + 1 for i, r in enumerate(refreshes) if r] == [10, 20]
    assert len(refreshes) == 23


def _check_fresh(p_best, p_loss, j_best, j_loss, start_loss):
    p_loss, j_loss = p_loss.numpy(), np.asarray(j_loss)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-2)
    assert (p_loss < start_loss).all() and (j_loss < start_loss).all()
    assert _max_abs_diff(p_best, j_best) <= 4 * LR * N_STEPS


def _start_loss(pf, stacked, target, n):
    fns = PhaseFns(pf, tree_from_numpy(stacked, "cpu"), "none", "hardround", {"mse": 1.0},
                   (0.95, 0.95), (0.9, 0.999), 10)
    leaves = tree_leaves(tree_from_numpy(stacked, "cpu"))
    return fns.eval(leaves, torch.tensor(target).expand(n, -1, -1, -1), 1e-3).loss.numpy()


def test_main_phase_n1():
    """_batched_phase at n = 1 with the keys JAX's encode_one_frame gives
    the main phase (_frame_phase_key, the seeding key folded from it)."""
    jf, pf, stacked, target = _setup(1, perturb=True)
    kb = np.asarray(_frame_phase_key(0, 0, 0)[None])
    seed_keys = jax.vmap(lambda k: jax.random.fold_in(k, 13))(jnp.asarray(kb))
    # the JAX window donates its key buffer: hand it a copy
    j_best, j_loss = j_batched_phase(
        jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(target)[None], jf,
        JPhase(**MAIN), jax.random.PRNGKey(0), None, JMonitor(), False,
        keys_b=jnp.array(kb))
    p_best, p_loss = p_batched_phase(
        tree_from_numpy(stacked, "cpu"), torch.tensor(target), pf, PPhase(**MAIN),
        PMonitor(), False, noise_source=JaxNoise(kb, seed_keys))
    _check_fresh(p_best, p_loss, j_best, j_loss, _start_loss(pf, stacked, target, 1))


def test_warmup_phase_n3():
    """Three warm-up candidates at init, JAX's train/warmup.py:
    _train_phase_batched against the port's (held lr, temperature and
    noise; no SOAP seeding)."""
    jf, pf, stacked, target = _setup(3, perturb=False)
    key = jax.random.PRNGKey(11)
    j_best, j_loss = j_warmup_phase(jax.tree_util.tree_map(jnp.asarray, stacked), 3,
                                    JPhase(**WARMUP), jf, jnp.asarray(target), None, None,
                                    key, JMonitor())
    p_best, p_loss = p_warmup_phase(tree_from_numpy(stacked, "cpu"), PPhase(**WARMUP), pf,
                                    torch.tensor(target), JaxNoise(jax.random.split(key, 3)),
                                    PMonitor())
    _check_fresh(p_best, p_loss, j_best, j_loss, _start_loss(pf, stacked, target, 3))


@pytest.mark.parametrize("name", ["intra", "debug", "measure_speed"])
@pytest.mark.parametrize("n_itr", [2000, 5000, 10000, 150, 1000])
def test_presets_match_jax(name, n_itr, monkeypatch):
    """The port's presets are the JAX package's phase for phase. Under
    2000 iterations the intra preset runs the relaxed-floor schedule: the
    port's itr_floor keyword against the JAX package's COOLCHIC_ITR_FLOOR."""
    from coolchic_tpu.train.presets import AVAILABLE_PRESETS as J
    from coolchic_tpu_torch.train.presets import AVAILABLE_PRESETS as P

    kw = dict(lmbda=2e-4, start_lr=1e-2, itr_main_training=n_itr)
    p_kw = dict(kw)
    if n_itr < 2000 and name == "intra":
        monkeypatch.setenv("COOLCHIC_ITR_FLOOR", "100")
        p_kw["itr_floor"] = 100
    j, p = J[name](**kw), P[name](**p_kw)
    assert repr(p.training_phases) == repr(j.training_phases)
    assert repr(p.warmup) == repr(j.warmup)
    for lam in (2e-4, 1e-3, 2e-2):
        assert p.warmup_noise_parameter(lam) == j.warmup_noise_parameter(lam)


def test_intra_floor_refuses_short_budgets():
    """The intra preset refuses a budget under its floor: 2000 unless
    itr_floor relaxes it; a preset built without itr_floor is unchanged."""
    from coolchic_tpu_torch.train.presets import PresetIntra

    kw = dict(lmbda=1e-3, start_lr=1e-2)
    with pytest.raises(ValueError, match="2000"):
        PresetIntra(**kw, itr_main_training=1999)
    with pytest.raises(ValueError, match="100"):
        PresetIntra(**kw, itr_main_training=99, itr_floor=100)
    assert repr(PresetIntra(**kw, itr_main_training=2000, itr_floor=5).training_phases) == \
        repr(PresetIntra(**kw, itr_main_training=2000).training_phases)


def test_warmup_holds_schedules(monkeypatch):
    """The warm-up phase holds lr, temperature and noise at their start and
    seeds no SOAP basis, as the JAX package's warm-up window does."""
    import coolchic_tpu_torch.train.warmup as w

    ph = PPhase(lmbda=1e-3, lr=3e-3, schedule_lr=True, softround_temperature=(0.3, 0.1),
                noise_parameter=(2.0, 0.5))
    seen = {}

    def fake_phase(stacked, targets, fcfg, phase, monitor, verbose, **kw):
        seen.update(phase=phase, seed_soap=kw["seed_soap"], n=targets.shape[0])
        return stacked, torch.zeros(2)

    monkeypatch.setattr(w, "_batched_phase", fake_phase)
    w._train_phase_batched({"global_flow_1": torch.zeros(2, 2)}, ph, None,
                           torch.zeros(1, 3, 2, 2), None, PMonitor())
    assert seen == {"phase": dataclasses.replace(ph, schedule_lr=False,
                                                 softround_temperature=(0.3, 0.3),
                                                 noise_parameter=(2.0, 2.0)),
                    "seed_soap": False, "n": 2}
