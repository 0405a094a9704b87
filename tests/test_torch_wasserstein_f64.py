"""The conditioning of the --tune wasserstein training step: the port's f32
step against the same step in f64 (every parameter, the noise, the target,
the common randomness and the VGG16 weights cast), on the CPU, at the
32x48 crop of tests/test_torch_wasserstein.py with its perturbed lop
params (seeds 1-3), the CLI's loss weights (mse 0.2, Wasserstein 0.8 / 200)
and the debug recipe's main phase.

What it pins: the loss agrees with f64 to 1e-6 and most leaves' gradients
to about 1e-6 (median), but on a few leaves (the ARM's and the latents',
through the rate of symbols near the 2^-16 probability floor) the f32 step
itself lies 1.7e-4 to 1.5e-2 from the exact one. Two f32 steps (the card's
and the CPU's) therefore need not agree to 1e-3 on every leaf, which is why
chip_smoke.py phase 7 holds the card against an f64 step, at a factor of
the CPU f32 step's own distance from it, and no longer against the CPU f32
step at 1e-3.

Where the distance comes from, also pinned: with only the rate
(core/laplace.py:rate_bits) computed in f64, the f32 step lies within
5e-5 of f64 on every leaf. The rate's f32 CDF difference loses about
2^-24 / p of a symbol's probability p, which is large near the 2^-16
floor; and a symbol whose exact probability sits just above the floor
can land on it in f32, where the max splits its gradient in half. At
seed 2 one symbol does (exactly 2^-16 in f32, 1.0006 x 2^-16 in f64),
the JAX package's f32 rate gives it the same probability and gradient,
and computing that one symbol in f64 takes the worst leaf from 1.5e-2 to
below 5e-4.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coolchic_tpu_torch.models.coolchic as ccm
from coolchic_tpu.core.laplace import rate_bits as j_rate_bits
from coolchic_tpu_torch.core.constants import MIN_PROBA
from coolchic_tpu_torch.core.laplace import laplace_cdf, rate_bits
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.models.frame import frame_cr_grids
from coolchic_tpu_torch.models.params import tree_from_numpy
from coolchic_tpu_torch.train.params import tree_flatten_with_path, tree_leaves, tree_map
from coolchic_tpu_torch.train.presets import PresetDebug
from coolchic_tpu_torch.train.train import PhaseFns, TorchNoise
from tests.test_torch_wasserstein import _cr_setup

torch.set_num_threads(2)
DIST = {"mse": 0.2, "wasserstein": 0.8 / 200}
LMBDA = 1e-4


def _step(pf, params, target, phase, noise, dt):
    like = tree_map(lambda x: x.to(dt), tree_from_numpy(
        tree_map(lambda x: np.asarray(x)[None], params), "cpu"))
    cr = {k: None if v is None else [g.to(dt) for g in v]
          for k, v in frame_cr_grids(pf).items()}
    fns = PhaseFns(pf, like, phase.quantizer_noise_type, phase.quantizer_type, DIST,
                   tuple(phase.betas_model), tuple(phase.betas_latent),
                   phase.precondition_frequency_model, cr=cr)
    args = (tree_leaves(like), {k: [x.to(dt) for x in v] for k, v in noise.items()},
            phase.softround_temperature[0], torch.tensor(target).to(dt),
            torch.full((1,), LMBDA, dtype=dt))
    return float(fns.loss(*args).loss[0]), fns.grads(*args), like


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wasserstein_step_f32_against_f64(seed):
    _, _, _, pf, params, target = _cr_setup((32, 48), seed=seed)
    phase = PresetDebug(lmbda=LMBDA, start_lr=1e-2, itr_main_training=1,
                        dist_weight=DIST).training_phases[0]
    noise = TorchNoise(torch.Generator().manual_seed(0))(
        "step", pf, 1, phase.quantizer_noise_type, torch.tensor([phase.noise_parameter[0]]),
        True)
    l32, g32, like = _step(pf, params, target, phase, noise, torch.float32)
    l64, g64, _ = _step(pf, params, target, phase, noise, torch.float64)
    assert all(g.dtype == torch.float64 for g in g64 if g is not None)
    assert abs(l32 - l64) <= 1e-6 * abs(l64), (l32, l64)
    errs = sorted(float((a.double() - b).norm() / b.norm())
                  for (_, _), a, b in zip(tree_flatten_with_path(like), g32, g64)
                  if b is not None and float(b.abs().max()) != 0.0)
    assert errs[len(errs) // 2] <= 1e-5, errs
    # the ill-conditioned leaves: f32 itself is this far from exact
    assert 1e-4 <= errs[-1] <= 5e-2, errs[-1]
    if seed == 2:
        assert errs[-1] > 1e-3    # beyond the old card-against-CPU bar on its own


def _setup(seed):
    _, _, _, pf, params, target = _cr_setup((32, 48), seed=seed)
    phase = PresetDebug(lmbda=LMBDA, start_lr=1e-2, itr_main_training=1,
                        dist_weight=DIST).training_phases[0]
    noise = TorchNoise(torch.Generator().manual_seed(0))(
        "step", pf, 1, phase.quantizer_noise_type, torch.tensor([phase.noise_parameter[0]]),
        True)
    return pf, params, target, phase, noise


def _worst(like, g, g64):
    return max(float((a.double() - b).norm() / b.norm())
               for (_, _), a, b in zip(tree_flatten_with_path(like), g, g64)
               if b is not None and float(b.abs().max()) != 0.0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wasserstein_step_conditioning_is_the_rate(seed, monkeypatch):
    pf, params, target, phase, noise = _setup(seed)
    _, g64, like = _step(pf, params, target, phase, noise, torch.float64)
    monkeypatch.setattr(ccm, "rate_bits", lambda x, mu, scale: rate_bits(
        x.double(), mu.double(), scale.double()).to(x.dtype))
    _, g32, _ = _step(pf, params, target, phase, noise, torch.float32)
    assert _worst(like, g32, g64) <= 5e-5


def _proba(x, mu, scale):
    return laplace_cdf(x + 0.5, mu, scale) - laplace_cdf(x - 0.5, mu, scale)


def test_floor_branch_symbol(monkeypatch):
    pf, params, target, phase, noise = _setup(2)
    seen = []

    def capture(x, mu, scale):
        seen.append((x.detach(), mu.detach(), scale.detach()))
        return rate_bits(x, mu, scale)

    monkeypatch.setattr(ccm, "rate_bits", capture)
    _, g64, like = _step(pf, params, target, phase, noise, torch.float64)
    _, g32, _ = _step(pf, params, target, phase, noise, torch.float32)
    (x64, m64, s64), (x32, m32, s32) = seen[0], seen[-1]
    p64, p32 = _proba(x64, m64, s64), _proba(x32, m32, s32)
    flip = (p32 > MIN_PROBA) != (p64 > MIN_PROBA)
    assert int(flip.sum()) == 1
    i = int(torch.nonzero(flip.flatten())[0])
    assert float(p32.flatten()[i]) == MIN_PROBA
    assert MIN_PROBA < float(p64.flatten()[i]) <= 1.001 * MIN_PROBA

    # that symbol's rate and gradient in f32: the port's equal JAX's, the
    # max's equality split giving half of the f64 gradient
    x, mu, scale = (float(t.flatten()[i]) for t in (x32, m32, s32))
    xt = torch.tensor(x, requires_grad=True)
    r32 = rate_bits(xt, torch.tensor(mu), torch.tensor(scale))
    r32.backward()
    j_r, j_g = jax.value_and_grad(lambda v: j_rate_bits(v, jnp.float32(mu), jnp.float32(scale)))(
        jnp.float32(x))
    assert float(r32.detach()) == float(j_r) and float(xt.grad) == float(j_g)
    x64t = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    rate_bits(x64t, torch.tensor(mu, dtype=torch.float64),
              torch.tensor(scale, dtype=torch.float64)).backward()
    assert float(xt.grad) == pytest.approx(0.5 * float(x64t.grad), rel=1e-3)

    # that one symbol carries the step's worst leaf
    mask = flip

    def mixed(x, mu, scale):
        exact = rate_bits(x.double(), mu.double(), scale.double()).to(x.dtype)
        return torch.where(mask.reshape(x.shape), exact, rate_bits(x, mu, scale))

    monkeypatch.setattr(ccm, "rate_bits", mixed)
    _, g_mixed, _ = _step(pf, params, target, phase, noise, torch.float32)
    assert _worst(like, g32, g64) > 1e-2
    assert _worst(like, g_mixed, g64) < 5e-4


def _relu_flip(monkeypatch):
    """Seed 1's setup, with the rate in f64, and the first hidden layer's
    bias of unit 3 set so that symbol 1563's exact pre-activation sits just
    above 0 and its f32 one at or below it (`flip`), or 1e-6 higher
    (`above`). Also returns `with_bias`, the pre-activations `pre(p, dt)`
    and the step's f32 contexts."""
    from coolchic_tpu_torch.models.arm import _linear

    pf, params, target, phase, noise = _setup(1)
    monkeypatch.setattr(ccm, "rate_bits", lambda x, mu, scale: rate_bits(
        x.double(), mu.double(), scale.double()).to(x.dtype))
    arm_rate, ctx = ccm._arm_rate, {}

    def capture(arm, lat, c):
        ctx[c.dtype] = c.detach()
        return arm_rate(arm, lat, c)

    monkeypatch.setattr(ccm, "_arm_rate", capture)
    for dt in (torch.float64, torch.float32):
        _step(pf, params, target, phase, noise, dt)
    monkeypatch.setattr(ccm, "_arm_rate", arm_rate)

    def with_bias(bias):
        arm = params["residue"]["arm"]
        layers = [{**arm["layers"][0], "bias": bias}] + arm["layers"][1:]
        return {**params, "residue": {**params["residue"], "arm": {**arm, "layers": layers}}}

    def pre(p, dt):
        # the hidden layers' pre-activations [n_hidden, n_latents, C], as
        # models/arm.py:arm_apply computes them on the step's contexts
        y, out = ctx[dt], []
        for lay in p["residue"]["arm"]["layers"][:-1]:
            lay = {k: torch.tensor(v)[None].to(dt) for k, v in lay.items()}
            z = _linear(y, lay) + y
            out.append(z[0])
            y = torch.relu(z)
        return torch.stack(out)

    s, u = 1563, 3
    bias0 = params["residue"]["arm"]["layers"][0]["bias"]
    edge = np.float32(bias0[u] - np.float32(pre(params, torch.float64)[0, s, u]))
    flip = None
    for k in range(64):
        for step in (np.float32(np.inf), np.float32(-np.inf)):
            b = bias0.copy()
            b[u] = edge
            for _ in range(k):
                b[u] = np.nextafter(b[u], step)
            p = with_bias(b)
            if (pre(p, torch.float32)[0, s, u] > 0) != (pre(p, torch.float64)[0, s, u] > 0):
                flip = b
                break
        if flip is not None:
            break
    assert flip is not None
    above = flip.copy()
    above[u] += np.float32(1e-6)
    return SimpleNamespace(pf=pf, target=target, phase=phase, noise=noise, flip=flip,
                           above=above, with_bias=with_bias, pre=pre, ctx=ctx[torch.float32],
                           s=s, u=u)


def test_arm_relu_branch(monkeypatch):
    """One hidden ReLU of the ARM on the other side of 0 in f32 than in f64:
    the branch behind the card's worst leaves at 512x768 (chip_smoke.py
    phase 7 prints the ReLUs each f32 step flips). The first hidden layer's
    bias of unit 3 is set so that symbol 1563's exact pre-activation sits
    just above 0 and its f32 one at or below it; the rate runs in f64, so
    that the floor stays out of it. That one branch takes the f32 step's
    worst leaf from about 1.6e-5 to above 1e-3, while the same bias 1e-6
    higher (both steps on the active side) leaves it where it was. The
    JAX package's f32 ARM puts that pre-activation within rounding of 0
    too: the branch is the formula's, relu(W y + b + y)."""
    from coolchic_tpu.models.arm import arm_apply as j_arm_apply

    r = _relu_flip(monkeypatch)
    pf, target, phase, noise, flip, above = r.pf, r.target, r.phase, r.noise, r.flip, r.above
    with_bias, pre, s, u = r.with_bias, r.pre, r.s, r.u

    worst = {}
    for name, b in (("flip", flip), ("above", above)):
        p = with_bias(b)
        assert int(((pre(p, torch.float32) > 0) != (pre(p, torch.float64) > 0)).sum()) == (
            1 if name == "flip" else 0)
        _, g64, like = _step(pf, p, target, phase, noise, torch.float64)
        _, g32, _ = _step(pf, p, target, phase, noise, torch.float32)
        worst[name] = _worst(like, g32, g64)
    assert worst["flip"] > 1e-3 and worst["above"] < 5e-5, worst

    j_arm = jax.tree_util.tree_map(jnp.asarray, with_bias(flip)["residue"]["arm"])
    j_layer = j_arm["layers"][0]
    x = jnp.asarray(r.ctx[0].numpy())
    j_pre = x @ j_layer["weight"].T + j_layer["bias"] + x
    assert abs(float(j_pre[s, u])) < 1e-7
    assert j_arm_apply(j_arm, x).shape == (x.shape[0], 2)


@pytest.mark.parametrize("case", ["floor", "relu"])
def test_phase7_check_forces_the_branches(case, monkeypatch):
    """chip_smoke.py phase 7's step check, run end to end with the CPU in
    the card's place, on the two branches pinned above: seed 2's symbol on
    the 2^-16 floor, and the ARM ReLU across 0 (rate back in f32). Either
    one takes the f32 step's worst leaf beyond 1e-3 on its own; with the
    ARM's ReLUs and the floor taken as the f64 step takes them, that leaf
    falls below 5e-4 (what stays is the f32 rate's own rounding near the
    floor, 5.4e-4 on latents[7] at seed 1). The check holds the card's
    forced step against the CPU's forced step for that reason."""
    import chip_smoke

    if case == "floor":
        pf, params, target, phase, _ = _setup(2)
    else:
        r = _relu_flip(monkeypatch)
        monkeypatch.undo()
        pf, params, target, phase = r.pf, r.with_bias(r.flip), r.target, r.phase
    res = chip_smoke.wasserstein_step_check(torch.device("cpu"), params, pf,
                                            FrameData(8, "rgb", target), phase)
    worst, branches = res["f64_worst"], res["branches"]["cpu"]
    forced = res["f64_leaf_errors"]["cpu, f64's branches"]
    assert worst["cpu"][0] > 1e-3, worst
    assert forced[worst["cpu"][1]] < 5e-4, (worst, forced[worst["cpu"][1]])
    assert worst["cpu, f64's branches"][0] < worst["cpu"][0] / 5, worst
    assert res["f64_forced_ratio"] == pytest.approx(1.0, rel=1e-6)
    assert res["rounding"]["card"] == res["rounding"]["cpu"]
    if case == "floor":
        assert len(branches["floor (grid, row, col, p64 / floor, p / floor)"]) == 1, branches
    else:
        assert any(t[0] == 0 for t in branches["relu (layer, grid, row, col, z64, z)"]), branches
