"""The port's training step from JAX's carried state, step by step, with
JAX's own noise draws injected (the first kind of comparison that
tests/test_torch_train_step.py describes), on a 64x96 crop of kodim15: at
n = 1 (the main phase) and n = 3 (three warm-up candidates). In a file of
its own so that the test runner's workers spread the two files."""

import jax
import jax.numpy as jnp
import pytest
import torch

from coolchic_tpu.train.presets import TrainerPhase as JPhase
from coolchic_tpu.train.train import _make_fns
from coolchic_tpu.train.train import init_opt_state as j_init_opt_state
from coolchic_tpu.train.train import seed_opt_state as j_seed_opt_state
from coolchic_tpu_torch.models.params import soap_state_from_jax, tree_from_numpy
from coolchic_tpu_torch.train.params import tree_leaves
from coolchic_tpu_torch.train.train import PhaseFns
from tests.test_torch_train_step import (
    LR,
    MAIN,
    N_STEPS,
    WARMUP,
    JaxNoise,
    _max_abs_diff,
    _setup,
    _stack_np,
)

torch.set_num_threads(2)

# The carried-state steps run on a crop of the image: the bar is per
# coordinate, and a quarter of the pixels keeps the test inside its time.
CARRIED_CROP = (64, 96)


def carried_steps(n, lmbdas, noises, crop=CARRIED_CROP):
    """JAX trains each slot 12 steps, then one window of 11 steps; before
    each step the port takes JAX's parameters and SOAP state and the same
    noise draws (after the refresh step its own refreshed state), and after
    it every coordinate is held within 5e-2 * lr of JAX's. Slot i trains at
    rate point lmbdas[i] with noise level noises[i]."""
    jf, pf, stacked, target = _setup(n, perturb=True, crop=crop)
    ph = JPhase(**(MAIN if n == 1 else WARMUP))
    pfreq = ph.precondition_frequency_model

    def j_fns(precondition_frequency, lmbda):
        return _make_fns(jf, ph.quantizer_noise_type, ph.quantizer_type, (("mse", 1.0),),
                         lmbda, tuple(ph.betas_model), tuple(ph.betas_latent),
                         precondition_frequency, N_STEPS, False)

    # JAX's plain step: a window of length 1 (no block); its refresh step:
    # a window of one block of length 1 (precondition frequency 1)
    fns = [(j_fns(pfreq, lam), j_fns(1, lam)) for lam in lmbdas]
    tgt = jnp.asarray(target)
    temp = 0.3

    def j_step(i, state, refresh):
        params, opt, key = state
        return fns[i][1 if refresh else 0]["train_window"](
            params, opt, key, jnp.float32(LR), jnp.float32(temp), jnp.float32(noises[i]), tgt,
            None, None, length=1)

    # JAX, per slot: seed (main phase only), 12 steps, then the window
    slots = []
    for i in range(n):
        f = fns[i][0]
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x[i]), stacked)
        key = jax.random.PRNGKey(20 + i)
        opt = j_init_opt_state(params, f["hp_weight"], f["hp_latent"])
        if n == 1:
            key, sub = jax.random.split(key)
            g0 = f["grad_fn"](params, sub, jnp.float32(temp), jnp.float32(noises[i]), tgt,
                              None, None)
            opt = j_seed_opt_state(params, opt, g0, f["hp_weight"])
        slots.append(f["train_window"](
            params, opt, key, jnp.float32(LR), jnp.float32(temp), jnp.float32(noises[i]), tgt,
            None, None, length=12))

    like = tree_from_numpy(_stack_np([p for p, _, _ in slots]), "cpu")
    treedef = jax.tree_util.tree_structure(slots[0][0])
    pfns = PhaseFns(pf, like, ph.quantizer_noise_type, ph.quantizer_type, ph.dist_weight,
                    tuple(ph.betas_model), tuple(ph.betas_latent), pfreq)
    level = torch.tensor(noises, dtype=torch.float32)
    lmbda = torch.tensor(lmbdas, dtype=torch.float32)
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
        slots = [j_step(i, s, refresh) for i, s in enumerate(slots)]
        worst = _max_abs_diff(leaves, _stack_np([p for p, _, _ in slots]))
        assert worst <= 5e-2 * LR, (t, worst)


@pytest.mark.parametrize("n", [1, 3])
def test_window_steps_from_carried_state(n):
    carried_steps(n, [1e-3] * n, [0.2 if n == 1 else 1.0] * n)


