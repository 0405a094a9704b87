"""The serial trainer train.train(), which the port's encoder runs for
--tune wasserstein configs (common randomness), against the JAX package's
train() (32x48 crop of kodim15, lop with common randomness, the MSE loss:
the trainer's windows, evals, patience and best snapshot do not depend on
the loss, and it keeps JAX's compile short; tests/test_torch_wasserstein_
step.py holds the Wasserstein step).

From JAX's parameters with JAX's noise (the seeding gradient's key and one
per step, replayed): a fresh SOAP state diverges as
tests/test_torch_train_step.py explains, so the phase is held to that
file's whole-phase bar (best loss within 1e-2 relative, both below the
start, every coordinate within 4 * lr * steps), and its counters are the
JAX trainer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from coolchic_tpu.models.frame import frame_cr_grids as j_cr_grids
from coolchic_tpu.train.presets import TrainerPhase as JPhase
from coolchic_tpu.train.train import EncoderMonitor as JMonitor
from coolchic_tpu.train.train import train as j_train
from coolchic_tpu_torch.models.frame import frame_cr_grids as p_cr_grids
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.train.params import tree_leaves
from coolchic_tpu_torch.train.presets import TrainerPhase as PPhase
from coolchic_tpu_torch.train.train import EncoderMonitor as PMonitor
from coolchic_tpu_torch.train.train import PhaseFns
from coolchic_tpu_torch.train.train import train as p_train
from tests.test_torch_train_step import JaxNoise, _max_abs_diff, _stack_np
from tests.test_torch_wasserstein import _cr_setup

torch.set_num_threads(2)
N_STEPS, LR, LMBDA = 11, 1e-2, 1e-3


def _phase_kw(dist):
    return dict(lmbda=LMBDA, lr=LR, max_itr=N_STEPS, freq_valid=N_STEPS, patience=100000,
                schedule_lr=True, quantizer_type="softround", quantizer_noise_type="gaussian",
                softround_temperature=(0.35, 0.08), noise_parameter=(0.22, 0.15),
                precondition_frequency_model=10, dist_weight=dist)


def test_serial_train_matches_jax():
    jcfg, pcfg, jf, pf, params, target = _cr_setup((32, 48), seed=1)
    key = jax.random.PRNGKey(5)
    j_best = j_train(jax.tree_util.tree_map(jnp.asarray, params), jf, jnp.asarray(target),
                     JPhase(**_phase_kw({"mse": 1.0})), cr=j_cr_grids(jf), key=key,
                     monitor=JMonitor())
    # JAX's train() splits one key for the seeding gradient, then the
    # window splits one per step: the port's noise source replays both
    key_after, seed_key = jax.random.split(key)
    monitor = PMonitor()
    p_best = p_train(tree_from_numpy(params, "cpu"), pf, torch.tensor(target),
                     PPhase(**_phase_kw({"mse": 1.0})),
                     noise_source=JaxNoise([key_after], [seed_key]),
                     cr=p_cr_grids(pf, "cpu"), monitor=monitor)
    assert monitor.iterations_counter == N_STEPS and monitor.total_training_time_sec > 0
    fns = PhaseFns(pf, tree_from_numpy(_stack_np([params]), "cpu"), "none", "hardround",
                   {"mse": 1.0}, (0.95, 0.95), (0.9, 0.999), 10, cr=p_cr_grids(pf, "cpu"))

    def loss_of(tree):
        return float(fns.eval(tree_leaves(tree_from_numpy(_stack_np([tree]), "cpu")),
                              torch.tensor(target), LMBDA).loss[0])

    start = loss_of(params)
    j_loss = loss_of(jax.tree_util.tree_map(np.asarray, j_best))
    p_loss = loss_of(jax.tree_util.tree_map(lambda x: x.numpy(), p_best))
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-2)
    assert p_loss < start and j_loss < start
    assert _max_abs_diff(tree_from_numpy(_stack_np([jax.tree_util.tree_map(
        lambda x: x.numpy(), p_best)]), "cpu"), _stack_np([j_best])) <= 4 * LR * N_STEPS
