"""The weight and bias gradient of the ARM's float linear layers
(coolchic_tpu_torch/ops/arm_wgrad.py, models/arm.py:_linear).

On the CPU:
  - the plain version's dW and db are autograd's own backward of the
    parent's torch.baddbmm, bit for bit, at G = 1 and 3, B not a multiple of
    any chunk, and the ARM's and IFCE's widths;
  - the split of the rows over CTAs covers every row;
  - the wrapper takes strided X and dY;
  - _linear's forward is torch.baddbmm's, bit for bit, with and without a
    gradient, and without one it never enters the autograd Function;
  - the whole ARM's parameter gradients against the JAX package's, on the
    same numpy inputs;
  - one training step routes every linear layer with a gradient (the ARM's
    and the IFCE's) through the weight gradient, once each.

On the card (`cuda`, skipped without one; the JAX package is imported
inside the test that uses it, so that these also run where JAX is not
installed):
    python -m pytest --noconftest tests/test_torch_arm_wgrad.py -m cuda
"""

import numpy as np
import pytest
import torch

from coolchic_tpu_torch.models import arm
from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.ops import arm_wgrad as aw
from coolchic_tpu_torch.parallel.batch import batched_init
from coolchic_tpu_torch.train.params import tree_leaves
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.train import PhaseFns
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points

torch.set_num_threads(2)

WIDTHS = [(8, 2), (20, 20), (20, 2), (6, 6)]        # (C_in, C_out)
PHASE = dict(lmbda=1e-3, lr=1e-2, max_itr=2, freq_valid=1, patience=100000,
             quantizer_type="softround", quantizer_noise_type="gaussian",
             softround_temperature=(0.3, 0.3), noise_parameter=(0.25, 0.25),
             precondition_frequency_model=10)


def _inputs(G, B, ci, co, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((G, B, ci), generator=g)
    dy = torch.randn((G, B, co), generator=g)
    return x.to(device), dy.to(device)


def _autograd(x, dy):
    """The parent's weight and bias gradient: autograd through baddbmm."""
    G, _, ci = x.shape
    co = dy.shape[2]
    w = torch.zeros((G, co, ci), requires_grad=True)
    b = torch.zeros((G, co), requires_grad=True)
    y = torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))
    return torch.autograd.grad(y, (w, b), dy)


@pytest.mark.parametrize("ci,co", WIDTHS)
@pytest.mark.parametrize("G", [1, 3])
def test_plain_is_autograds_backward(G, ci, co):
    x, dy = _inputs(G, 1037, ci, co, seed=G * 100 + ci)
    dw, db = aw.arm_wgrad(x, dy)
    want_w, want_b = _autograd(x, dy)
    assert dw.shape == (G, co, ci) and db.shape == (G, co)
    assert torch.equal(dw, want_w) and torch.equal(db, want_b)
    # and it is the product it names (a transposed result would pass above
    # only if autograd's were transposed too)
    ref = torch.einsum("gbo,gbi->goi", dy.double(), x.double())
    assert torch.allclose(dw.double(), ref, rtol=1e-5, atol=1e-4)


def test_wrapper_refuses_mismatched_inputs():
    x, dy = _inputs(2, 10, 4, 3)
    with pytest.raises(ValueError):
        aw.arm_wgrad(x, dy[:1])
    with pytest.raises(ValueError):
        aw.arm_wgrad(x, dy.double())
    with pytest.raises(ValueError):
        aw.arm_wgrad(x[0], dy[0])


@pytest.mark.parametrize("G,B,n_sm", [(8, 524288, 132), (1, 524288, 132), (8, 98304, 132),
                                      (1, 6144, 132), (3, 1037, 132), (1, 1, 132),
                                      (2, 5000, 4), (64, 9999, 132)])
def test_split_covers_every_row(G, B, n_sm):
    S, chunk = aw.split(G, B, n_sm)
    assert S >= 1 and S * chunk >= B and (S - 1) * chunk < B
    assert chunk >= min(B, aw.MIN_CHUNK)
    assert G * S <= max(G, aw.CTAS_PER_SM * n_sm + G)


def _strided(t):
    """t's values in a [G, C, B] buffer seen as [G, B, C] (not contiguous)."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def test_wrapper_takes_strided_inputs():
    x, dy = _inputs(2, 300, 20, 6)
    want = aw.arm_wgrad(x, dy)
    got = aw.arm_wgrad(_strided(x), _strided(dy))
    # the CPU's bmm may sum another layout in another order
    assert all(torch.allclose(a, b, rtol=1e-5, atol=1e-5) for a, b in zip(got, want))


def _layer(G, ci, co, grad, seed=1):
    g = torch.Generator().manual_seed(seed)
    lay = {"weight": torch.randn((G, co, ci), generator=g),
           "bias": torch.randn((G, co), generator=g)}
    x = torch.randn((G, 333, ci), generator=g)
    if grad:
        for t in (x, lay["weight"], lay["bias"]):
            t.requires_grad_(True)
    return x, lay


@pytest.mark.parametrize("grad", [True, False])
def test_linear_forward_is_baddbmm(grad):
    x, lay = _layer(3, 20, 20, grad)
    y = arm._linear(x, lay)
    with torch.no_grad():
        want = torch.baddbmm(lay["bias"][:, None, :], x, lay["weight"].transpose(1, 2))
    assert torch.equal(y.detach(), want)
    assert (y.grad_fn is not None) == grad


def test_linear_without_grad_skips_the_function(monkeypatch):
    def refuse(*args):
        raise AssertionError("_linear entered the autograd Function without a gradient")

    monkeypatch.setattr(arm._Linear, "apply", refuse)
    x, lay = _layer(2, 8, 2, grad=True)
    with torch.no_grad():
        arm._linear(x, lay)
    x, lay = _layer(2, 8, 2, grad=False)
    arm._linear(x, lay)
    with pytest.raises(AssertionError):
        x, lay = _layer(2, 8, 2, grad=True)
        arm._linear(x, lay)


@pytest.mark.parametrize("dim,n_hidden,n_out,stab", [(20, 2, 2, True), (8, 2, 2, True),
                                                     (9, 0, 6, False)])
def test_arm_grads_match_jax(dim, n_hidden, n_out, stab):
    """The ARM's parameter gradients (and its input's) of sum(raw * cot),
    port against the JAX package, same numpy parameters, contexts and
    cotangent. Both sum in f32 over 777 rows in their own orders: within
    2e-5 of the gradient's largest entry."""
    import jax
    import jax.numpy as jnp

    from coolchic_tpu.models.arm import arm_apply as j_arm_apply

    rng = np.random.default_rng(dim + n_hidden)

    def lin(i, o):
        return {"weight": (rng.normal(size=(o, i)) / i).astype(np.float32),
                "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}

    params = {"layers": [lin(dim, dim) for _ in range(n_hidden)] + [lin(dim, n_out)]}
    if stab:
        params["stabiliser"] = lin(dim, n_out)
    x = rng.normal(size=(777, dim)).astype(np.float32)
    cot = rng.normal(size=(777, n_out)).astype(np.float32)

    j_grads = jax.grad(lambda p, xx: jnp.sum(j_arm_apply(p, xx) * cot), argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    t_params = jax.tree_util.tree_map(lambda a: torch.tensor(a[None], requires_grad=True), params)
    tx = torch.tensor(x[None], requires_grad=True)
    raw = arm.arm_apply(t_params, tx)
    leaves, treedef = jax.tree_util.tree_flatten(t_params)
    got = torch.autograd.grad((raw * torch.tensor(cot[None])).sum(), leaves + [tx])
    want = jax.tree_util.tree_leaves(j_grads[0]) + [j_grads[1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g[0].numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())


def _n_linear_with_grad(cfg) -> int:
    """The ARM's layers (hidden, output, stabiliser) and one per IFCE arm."""
    return (cfg.n_hidden_layers_arm + 1 + int(cfg.linear_stabiliser_arm)
            + sum(1 for f in cfg.input_features_ifce if f > 0))


def _one_step(op, G, size, dev):
    """One PhaseFns training step of G slots of `op` at `size` on dev."""
    cfg = coolchic_config_from_args(intra_operating_points()[op], size)
    fcfg = FrameConfig(coolchic_cfg={"residue": cfg})
    phase = TrainerPhase(**PHASE)
    params, opt = batched_init(fcfg, phase, G, seed=0, device=dev)
    fns = PhaseFns(fcfg, params, phase.quantizer_noise_type, phase.quantizer_type, {"mse": 1.0},
                   (0.95, 0.95), (0.9, 0.999), phase.precondition_frequency_model)
    g = torch.Generator(device=dev).manual_seed(3)
    target = torch.rand((G, 3, *size), generator=g, device=dev)
    lmbda = torch.full((G,), 1e-3, device=dev)
    lr = torch.tensor(1e-2, device=dev)

    def step():
        return fns.step(tree_leaves(params), opt, None, 0.3, lr, target, lmbda, refresh=False)

    return cfg, fns, step, target, lmbda, tree_leaves(params)


def test_step_routes_every_linear_once(monkeypatch):
    calls = []
    real = arm.arm_wgrad

    def counted(x, dy):
        calls.append((tuple(x.shape), dy.shape[2]))
        return real(x, dy)

    monkeypatch.setattr(arm, "arm_wgrad", counted)
    cfg, fns, step, target, lmbda, leaves = _one_step("hop", 2, (32, 48), "cpu")
    step()
    assert len(calls) == _n_linear_with_grad(cfg) == 7
    # the ARM's four layers run over every latent pixel of every grid
    n_latents = sum(h * w for h, w in cfg.size_per_latent)
    assert sum(1 for (G, B, _), _ in calls if B == n_latents) == 4
    calls.clear()
    fns.eval(leaves, target, lmbda)
    assert calls == []


# ---------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (G, C_in, C_out) of one step at 512x768: hop's ARM (hidden, output and
# stabiliser) and its largest IFCE arm at G = 8, lop's at G = 1
CARD = [(8, 524288, 20, 20), (8, 524288, 20, 2), (8, 98304, 9, 6), (1, 524288, 8, 8),
        (1, 524288, 8, 2), (1, 98304, 9, 2), (3, 1037, 64, 64)]


# The kernel's limit against an f64 sum: each output's error over the root
# of the sum of its terms' squares, the size that independent roundings of
# the terms add up to (chip_smoke.py's WGRAD_TOL). On an H100 at a 512x768
# step's layers the kernel reads at most 2.2e-6 and TF32, which rounds
# each term by about 2^-11 of itself, at least 4.6e-4.
KERNEL_TOL = 3e-5
# The kernel against its plain version (WGRAD_PLAIN_TOL), and the plain
# version (cuBLAS, one unsplit chain of adds an output) against the f64
# sum: each output's difference over the sum of its terms' magnitudes.
PLAIN_TOL = 1e-6
PLAIN_F64_TOL = 1e-5


def _errors(got, x, dy, ref=None):
    """(largest |got - want| / sum |terms|, ... / sqrt(sum terms^2)) over dW
    and db, want the f64 sums or `ref`."""
    xd, dd = x.double(), dy.double()
    out = [0.0, 0.0]
    for k, (eq, a) in enumerate((("gbo,gbi->goi", xd), ("gbo,gb->go", torch.ones_like(xd[..., 0])))):
        if got[k] is None:
            continue
        want = torch.einsum(eq, dd, a) if ref is None else ref[k].double()
        err = (got[k].double() - want).abs()
        out[0] = max(out[0], float((err / torch.einsum(eq, dd.abs(), a.abs())).max()))
        out[1] = max(out[1], float((err / torch.einsum(eq, dd * dd, a * a).sqrt()).max()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,ci,co", CARD)
def test_kernel_matches_plain_cuda(G, B, ci, co):
    """The kernel against an f64 sum (KERNEL_TOL) and its plain version
    (PLAIN_TOL); the plain version against the f64 sum (PLAIN_F64_TOL)."""
    dev = _card()
    x, dy = _inputs(G, B, ci, co, seed=B + ci, device=dev)
    before = aw.KERNEL.launches
    got = aw.arm_wgrad(x, dy)
    torch.cuda.synchronize()
    assert aw.KERNEL.launches == before + 1
    assert got[0].shape == (G, co, ci) and got[1].shape == (G, co)
    plain = aw.arm_wgrad_plain(x, dy)
    assert _errors(got, x, dy)[1] <= KERNEL_TOL
    assert _errors(got, x, dy, ref=plain)[0] <= PLAIN_TOL
    assert _errors(plain, x, dy)[0] <= PLAIN_F64_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,ci,co", CARD[:2] + CARD[3:4])
def test_tf32_controls_fail_the_limit_cuda(G, B, ci, co):
    """What the limit is for: dW from inputs rounded to TF32, and from
    torch.bmm with TF32 allowed, are both refused."""
    dev = _card()
    x, dy = _inputs(G, B, ci, co, seed=B + ci, device=dev)
    rounded = [((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32) for t in (x, dy)]
    tf32_in = torch.einsum("gbo,gbi->goi", rounded[1].double(), rounded[0].double())
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_bmm = torch.bmm(dy.transpose(1, 2), x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert _errors((tf32_in, None), x, dy)[1] > KERNEL_TOL
    assert _errors((tf32_bmm, None), x, dy)[1] > KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,ci,co", CARD[:2] + CARD[3:4])
def test_kernel_repeats_bit_for_bit_cuda(G, B, ci, co):
    dev = _card()
    x, dy = _inputs(G, B, ci, co, seed=7, device=dev)
    first = aw.arm_wgrad(x, dy)
    second = aw.arm_wgrad(x.clone(), dy.clone())
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_cuda():
    dev = _card()
    x, dy = _inputs(2, 100, 8, 2, device=dev)
    with pytest.raises(ValueError):
        aw.arm_wgrad(x.double(), dy.double())
    xs, ds = _inputs(2, 100, 65, 2, device=dev)
    with pytest.raises(ValueError):
        aw.arm_wgrad(xs, ds)


@pytest.mark.cuda
def test_kernel_takes_strided_and_misaligned_inputs_cuda():
    """A strided X and a dY 4 bytes past a 16-byte boundary give the bits
    of their contiguous copies."""
    dev = _card()
    x, dy = _inputs(2, 5000, 20, 6, seed=3, device=dev)
    want = aw.arm_wgrad(x, dy)
    buf = torch.empty(dy.numel() + 1, device=dev)
    shifted = buf[1:].view(dy.shape)
    shifted.copy_(dy)
    assert shifted.data_ptr() % 16 == 4
    got = aw.arm_wgrad(_strided(x), shifted)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("op,G", [("hop", 8), ("lop", 1)])
def test_step_launches_once_per_linear_cuda(op, G):
    dev = _card()
    cfg, _, step, _, _, _ = _one_step(op, G, (64, 96), dev)
    before = aw.KERNEL.launches
    step()
    torch.cuda.synchronize()
    assert aw.KERNEL.launches - before == _n_linear_with_grad(cfg) == 7
