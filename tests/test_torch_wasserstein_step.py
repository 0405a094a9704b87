"""The training step of a --tune wasserstein config in the port against the
JAX package: PhaseFns.step under the Wasserstein loss (the CLI's weights)
with common randomness, the step the serial trainer runs (32x48 crop of
kodim15, lop).

A window carried from JAX's parameters and SOAP state, as in
tests/test_torch_train_step.py: JAX takes 12 steps, then before each of 11
more (the QR refresh at step 10 included) its parameters and state are
carried into the port, which takes the same step with the same noise; step
11 starts from the port's own refreshed state. Every coordinate after each
step within 5e-2 * lr of JAX's. JAX runs one step at a time (train_window
of length 1; the refresh step through a precondition frequency of 1), so
three compiled programs serve the whole test.
"""

import jax
import jax.numpy as jnp
import torch

from coolchic_tpu.models.frame import frame_cr_grids as j_cr_grids
from coolchic_tpu.train.presets import TrainerPhase as JPhase
from coolchic_tpu.train.train import _make_fns
from coolchic_tpu.train.train import init_opt_state as j_init_opt_state
from coolchic_tpu.train.train import seed_opt_state as j_seed_opt_state
from coolchic_tpu_torch.models.frame import frame_cr_grids as p_cr_grids
from coolchic_tpu_torch.models.params import soap_state_from_jax, tree_from_numpy
from coolchic_tpu_torch.train.params import tree_leaves
from coolchic_tpu_torch.train.train import PhaseFns
from tests.test_torch_serial_train import _phase_kw
from tests.test_torch_train_step import JaxNoise, _max_abs_diff, _stack_np
from tests.test_torch_wasserstein import _cr_setup

torch.set_num_threads(2)
DIST = {"mse": 0.2, "wasserstein": 0.8 / 200}   # the CLI's --tune wasserstein weights
N_STEPS, LR, LMBDA = 11, 1e-2, 1e-3


def test_cr_wasserstein_window_steps_from_carried_state():
    jcfg, pcfg, jf, pf, params, target = _cr_setup((32, 48))
    ph = JPhase(**_phase_kw(DIST))
    j_cr, p_cr = j_cr_grids(jf), p_cr_grids(pf, "cpu")

    def j_fns(pfreq):
        return _make_fns(jf, ph.quantizer_noise_type, ph.quantizer_type,
                         tuple(sorted(DIST.items())), LMBDA, tuple(ph.betas_model),
                         tuple(ph.betas_latent), pfreq, N_STEPS, False)

    fns, fns_refresh = j_fns(10), j_fns(1)
    tgt = jnp.asarray(target)
    temp, noise = 0.3, 0.2
    params = jax.tree_util.tree_map(jnp.asarray, params)
    key = jax.random.PRNGKey(20)
    opt = j_init_opt_state(params, fns["hp_weight"], fns["hp_latent"])
    key, sub = jax.random.split(key)
    g0 = fns["grad_fn"](params, sub, jnp.float32(temp), jnp.float32(noise), tgt, None, j_cr)
    opt = j_seed_opt_state(params, opt, g0, fns["hp_weight"])
    slot = (params, opt, key)
    for t in range(1, 13):   # 12 steps in, from the window's start
        slot = (fns_refresh if t % 10 == 0 else fns)["train_window"](
            *slot, jnp.float32(LR), jnp.float32(temp), jnp.float32(noise), tgt, None, j_cr,
            length=1)

    like = tree_from_numpy(_stack_np([slot[0]]), "cpu")
    treedef = jax.tree_util.tree_structure(slot[0])
    pfns = PhaseFns(pf, like, ph.quantizer_noise_type, ph.quantizer_type, DIST,
                    tuple(ph.betas_model), tuple(ph.betas_latent), 10, cr=p_cr)
    targets = torch.tensor(target)
    after_refresh = None
    for t in range(1, N_STEPS + 1):
        refresh = t % 10 == 0
        leaves = tree_leaves(tree_from_numpy(_stack_np([slot[0]]), "cpu"))
        states = after_refresh or [
            soap_state_from_jax(None if s is None else _stack_np([s]), "cpu")
            for s in treedef.flatten_up_to(slot[1])]
        drawn = JaxNoise([slot[2]])("step", pf, 1, "gaussian", torch.full((1,), noise),
                                    pfns.need_noise)
        leaves, states = pfns.step(leaves, states, drawn, temp, torch.tensor(LR), targets,
                                   torch.full((1,), LMBDA), refresh=refresh)
        after_refresh = states if refresh else None
        slot = (fns_refresh if refresh else fns)["train_window"](
            slot[0], slot[1], slot[2], jnp.float32(LR), jnp.float32(temp),
            jnp.float32(noise), tgt, None, j_cr, length=1)
        worst = _max_abs_diff(leaves, _stack_np([slot[0]]))
        assert worst <= 5e-2 * LR, (t, worst)
