"""The port's training window and phase (train/train.py:PhaseFns.window,
parallel/encode_batch.py:_batched_phase, train/warmup.py) against the JAX
package's, with JAX's own noise draws injected into the port.

Two kinds of comparison, because a SOAP/Adam trajectory from a fresh
optimizer state is ill-conditioned:

  - From a carried state, step by step (test_window_steps_from_carried_
    state): JAX trains 12 steps, then runs one window of
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
from coolchic_tpu.train.train import _make_fns
from coolchic_tpu.train.train import init_opt_state as j_init_opt_state
from coolchic_tpu.train.train import seed_opt_state as j_seed_opt_state
from coolchic_tpu.train.video import _frame_phase_key
from coolchic_tpu.train.warmup import _train_phase_batched as j_warmup_phase
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.models.params import soap_state_from_jax, tree_from_numpy
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


def _setup(n, perturb):
    """Frame configs, n stacked JAX-initialized params (numpy), target."""
    frame = load_frame_data_from_file(IMG)
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


@pytest.mark.parametrize("n", [1, 3])
def test_window_steps_from_carried_state(n):
    jf, pf, stacked, target = _setup(n, perturb=True)
    ph = JPhase(**(MAIN if n == 1 else WARMUP))
    pfreq = ph.precondition_frequency_model

    def j_fns(precondition_frequency):
        return _make_fns(jf, ph.quantizer_noise_type, ph.quantizer_type, (("mse", 1.0),),
                         ph.lmbda, tuple(ph.betas_model), tuple(ph.betas_latent),
                         precondition_frequency, N_STEPS, False)

    # JAX's plain step: a window of length 1 (no block); its refresh step:
    # a window of one block of length 1 (precondition frequency 1)
    fns, fns_refresh = j_fns(pfreq), j_fns(1)
    tgt = jnp.asarray(target)
    temp, noise = 0.3, (0.2 if n == 1 else 1.0)

    def j_step(state, refresh):
        params, opt, key = state
        return (fns_refresh if refresh else fns)["train_window"](
            params, opt, key, jnp.float32(LR), jnp.float32(temp), jnp.float32(noise), tgt,
            None, None, length=1)

    # JAX, per slot: seed (main phase only), 12 steps, then the window
    slots = []
    for i in range(n):
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x[i]), stacked)
        key = jax.random.PRNGKey(20 + i)
        opt = j_init_opt_state(params, fns["hp_weight"], fns["hp_latent"])
        if n == 1:
            key, sub = jax.random.split(key)
            g0 = fns["grad_fn"](params, sub, jnp.float32(temp), jnp.float32(noise), tgt,
                                None, None)
            opt = j_seed_opt_state(params, opt, g0, fns["hp_weight"])
        slots.append(fns["train_window"](
            params, opt, key, jnp.float32(LR), jnp.float32(temp), jnp.float32(noise), tgt,
            None, None, length=12))

    like = tree_from_numpy(_stack_np([p for p, _, _ in slots]), "cpu")
    treedef = jax.tree_util.tree_structure(slots[0][0])
    pfns = PhaseFns(pf, like, ph.quantizer_noise_type, ph.quantizer_type, ph.dist_weight,
                    tuple(ph.betas_model), tuple(ph.betas_latent), pfreq)
    level = torch.full((n,), noise)
    lmbda = torch.full((n,), ph.lmbda)
    targets = torch.tensor(target).expand(n, -1, -1, -1)
    after_refresh = None
    for t in range(1, N_STEPS + 1):
        refresh = t % pfreq == 0
        # the port's step from JAX's parameters and state; after the
        # refresh step, from the port's own refreshed state
        leaves = tree_leaves(tree_from_numpy(_stack_np([p for p, _, _ in slots]), "cpu"))
        states = after_refresh or [
            soap_state_from_jax(None if s[0] is None else _stack_np(s), "cpu")
            for s in zip(*(treedef.flatten_up_to(o) for _, o, _ in slots))]
        drawn = JaxNoise([k for _, _, k in slots])(
            "step", pf, n, ph.quantizer_noise_type, level, pfns.need_noise)
        leaves, states = pfns.step(leaves, states, drawn, temp, torch.tensor(LR), targets,
                                   lmbda, refresh=refresh)
        after_refresh = states if refresh else None
        slots = [j_step(s, refresh) for s in slots]
        worst = _max_abs_diff(leaves, _stack_np([p for p, _, _ in slots]))
        assert worst <= 5e-2 * LR, (t, worst)


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
@pytest.mark.parametrize("n_itr", [2000, 5000, 10000])
def test_presets_match_jax(name, n_itr):
    """The port's presets are the JAX package's phase for phase."""
    from coolchic_tpu.train.presets import AVAILABLE_PRESETS as J
    from coolchic_tpu_torch.train.presets import AVAILABLE_PRESETS as P

    kw = dict(lmbda=2e-4, start_lr=1e-2, itr_main_training=n_itr)
    j, p = J[name](**kw), P[name](**kw)
    assert repr(p.training_phases) == repr(j.training_phases)
    assert repr(p.warmup) == repr(j.warmup)


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
