"""The batched phase's per-slot inputs (parallel/encode_batch.py:
_batched_phase: lmbda_b, noise_b, and one noise stream per slot through
train/train.py:SlotNoise) against the JAX package's (lmbda_b, noise_b,
keys_b), on a 64x96 crop of kodim15.

  - One window's steps at G = 2 with a different rate point and noise
    level per slot, from JAX's carried state with JAX's noise injected:
    every coordinate within 5e-2 * lr of JAX's after every step (the bar
    of tests/test_torch_train_window.py).
  - A window of steps at G = 2 with per-slot λ, noise levels and
    generators against slot 0 alone at n = 1, carried step by step: within
    the same 5e-2 * lr.
  - SlotNoise: slot i's draws are exactly its generator's draws at n = 1,
    the SOAP-seeding draw included, in a direct call and through a whole
    _batched_phase.
"""

import jax
import pytest
import torch

from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.parallel.encode_batch import _batched_phase
from coolchic_tpu_torch.train.params import tree_leaves
from coolchic_tpu_torch.train.presets import TrainerPhase as PPhase
from coolchic_tpu_torch.train.train import (
    EncoderMonitor,
    PhaseFns,
    SlotNoise,
    TorchNoise,
    init_opt_state,
)
from tests.test_torch_train_step import MAIN, _setup
from tests.test_torch_train_window import carried_steps

torch.set_num_threads(2)

LMBDAS = [1e-3, 4e-3]
NOISE_ROWS = [[0.22, 0.15], [0.3, 0.1]]


def test_window_steps_per_slot_rows_from_carried_state():
    carried_steps(2, LMBDAS, [0.2, 0.35])


def _slot(tree, i):
    """Slot i (kept as a batch of one) of nested lists / dicts of tensors."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree[i:i + 1]
    if isinstance(tree, dict):
        return {k: _slot(v, i) for k, v in tree.items()}
    return [_slot(v, i) for v in tree]


def _cat(a, b):
    if a is None or isinstance(a, torch.Tensor):
        return None if a is None else torch.cat([a, b])
    if isinstance(a, dict):
        return {k: _cat(a[k], b[k]) for k in a}
    return [_cat(x, y) for x, y in zip(a, b)]


def test_slot_steps_equal_n1_steps():
    """A window of steps at G = 2 (per-slot λ and noise levels, one
    generator per slot) against slot 0 alone at n = 1 with its generator,
    carried step by step: before each step slot 0 of the batch takes the
    n = 1 run's parameters and SOAP state; after it, every coordinate
    within 5e-2 * lr (the carried-state bar). The draws are the same
    (SlotNoise), so only the batch's float summation order differs."""
    _, pf, stacked, target = _setup(2, perturb=True, crop=(32, 48))
    lr, temp = torch.tensor(MAIN["lr"]), 0.3
    like2 = tree_from_numpy(stacked, "cpu")
    like1 = tree_from_numpy(jax.tree_util.tree_map(lambda x: x[:1], stacked), "cpu")
    mk = lambda like: PhaseFns(pf, like, "gaussian", "softround", {"mse": 1.0},  # noqa: E731
                               (0.95, 0.95), (0.9, 0.999), 10)
    f2, f1 = mk(like2), mk(like1)
    leaves2, leaves1 = tree_leaves(like2), tree_leaves(like1)
    states2 = init_opt_state(leaves2, f2.groups, f2.hp_weight, f2.hp_latent)
    states1 = _slot(states2, 0)
    noise2, noise1 = SlotNoise(_gens([8, 9])), TorchNoise(_gens([8])[0])
    level = torch.tensor([row[0] for row in NOISE_ROWS])
    targets = torch.tensor(target).expand(2, -1, -1, -1)
    for s in range(11):
        refresh = (s + 1) % f2.pf == 0
        leaves2 = _cat(leaves1, _slot(leaves2, 1))
        states2 = _cat(states1, _slot(states2, 1))
        leaves2, states2 = f2.step(leaves2, states2, noise2("step", pf, 2, "gaussian", level, True),
                                   temp, lr, targets, torch.tensor(LMBDAS), refresh=refresh)
        leaves1, states1 = f1.step(leaves1, states1,
                                   noise1("step", pf, 1, "gaussian", level[:1], True), temp, lr,
                                   torch.tensor(target), torch.tensor(LMBDAS[:1]),
                                   refresh=refresh)
        worst = max(float((a[:1] - b).abs().max()) for a, b in zip(leaves2, leaves1))
        assert worst <= 5e-2 * MAIN["lr"], (s, worst)


class Recorder:
    """A noise source that keeps every draw it hands out."""

    def __init__(self, inner):
        self.inner, self.draws = inner, []

    def __call__(self, *args):
        out = self.inner(*args)
        self.draws.append(out)
        return out


def _gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


@pytest.mark.parametrize("noise_type", ["gaussian", "kumaraswamy"])
def test_slot_noise_equals_n1_draws(noise_type):
    """Called as _batched_phase calls it (a seeding draw, then steps),
    SlotNoise gives slot i the draws TorchNoise gives its generator alone."""
    _, pf, _, _ = _setup(1, perturb=False, crop=(32, 48))
    levels = torch.tensor([0.2, 1.5, 0.7])
    slot = SlotNoise(_gens([5, 6, 7]))
    alone = [TorchNoise(g) for g in _gens([5, 6, 7])]
    for kind in ("seed", "step", "step", "step"):
        got = slot(kind, pf, 3, noise_type, levels, True)
        for i, src in enumerate(alone):
            want = src(kind, pf, 1, noise_type, levels[i:i + 1], True)
            for a, b in zip(got["residue"], want["residue"]):
                assert torch.equal(a[i:i + 1], b)
    assert slot("step", pf, 3, noise_type, levels, False) is None
    with pytest.raises(ValueError):
        slot("step", pf, 2, noise_type, levels[:2], True)


def test_batched_phase_slot_draws_equal_n1():
    """Through _batched_phase at G = 2 (per-slot noise rows) and at n = 1:
    slot i's draws, the SOAP-seeding one included, equal its generator's
    draws at n = 1, exactly."""
    _, pf, stacked, target = _setup(2, perturb=True, crop=(32, 48))
    phase = PPhase(**{**MAIN, "max_itr": 3, "freq_valid": 2})
    rec2 = Recorder(SlotNoise(_gens([11, 12])))
    _batched_phase(tree_from_numpy(stacked, "cpu"), torch.tensor(target).expand(2, -1, -1, -1),
                   pf, phase, EncoderMonitor(), False, noise_source=rec2, noise_b=NOISE_ROWS)
    for i, seed in enumerate((11, 12)):
        one = jax.tree_util.tree_map(lambda x: x[i:i + 1], stacked)
        rec1 = Recorder(TorchNoise(_gens([seed])[0]))
        _batched_phase(tree_from_numpy(one, "cpu"), torch.tensor(target), pf, phase,
                       EncoderMonitor(), False, noise_source=rec1, noise_b=NOISE_ROWS[i:i + 1])
        assert len(rec1.draws) == len(rec2.draws) == 1 + 3
        for d2, d1 in zip(rec2.draws, rec1.draws):
            for a, b in zip(d2["residue"], d1["residue"]):
                assert torch.equal(a[i:i + 1], b)
