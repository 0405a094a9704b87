"""SOAP's update of every leaf in one function
(coolchic_tpu_torch/train/soap.py:soap_step_all) and its replay as a CUDA
graph (soap.SoapUpdate, PhaseFns.update).

On the CPU:
  - soap_step_all is the update PhaseFns.step made before it, bit for bit:
    the weight group's clip, then soap_step_leaf a leaf (hop- and
    lop-shaped leaves, G = 1 and 3, with and without the refresh, from a
    state seeded and carried through a refresh);
  - PhaseFns.step on the CPU never captures: every step eager;
  - the replay's static buffers (inputs copied in, outputs copied out into
    fresh tensors, Q passed through as the caller's own tensor), with a
    stand-in graph that reruns the function into its static outputs.

On the card (`cuda`, skipped without one; nothing here imports JAX):
    python -m pytest --noconftest tests/test_torch_soap_graph.py -m cuda
  - the replays equal the eager update bit for bit over 12 steps (two
    refresh periods, the refresh steps eager) at 512x768, hop G = 8 and
    lop n = 1;
  - tensors returned at one step are unchanged after 5 more replays;
  - new shapes capture anew;
  - a data mesh that names cuda:0 twice replays the graph on both chunks.
"""

import contextlib

import pytest
import torch

from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.parallel.batch import batched_init, make_batched_window, make_mesh
from coolchic_tpu_torch.parallel.batch import phase_key
from coolchic_tpu_torch.train import soap
from coolchic_tpu_torch.train.params import FROZEN, WEIGHT, tree_leaves
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.soap import soap_step_all, soap_step_leaf
from coolchic_tpu_torch.train.train import PhaseFns, TorchNoise, seed_opt_state
from coolchic_tpu_torch.utils import trace
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points

torch.set_num_threads(2)
PF = 6
SIZE = (32, 48)


def _fns(op: str, G: int, size: tuple, dev, seed: int = 0):
    """A PhaseFns of `op` at `size`, G slots of fresh parameters and their
    SOAP states."""
    cfg = coolchic_config_from_args(intra_operating_points()[op], size)
    fcfg = FrameConfig(coolchic_cfg={"residue": cfg})
    phase = TrainerPhase(lmbda=1e-3, precondition_frequency_model=PF)
    params, opt = batched_init(fcfg, phase, G, seed=seed, device=dev)
    fns = PhaseFns(fcfg, params, "gaussian", "softround", {"mse": 1.0}, (0.95, 0.95),
                   (0.9, 0.999), PF)
    return fcfg, fns, tree_leaves(params), opt


def _grads(leaves, states, gen):
    """A gradient a leaf with a state (None for the others), from `gen`."""
    return [None if s is None else torch.randn(p.shape, generator=gen, device=p.device)
            for p, s in zip(leaves, states)]


def _seeded(fns, leaves, states, gen):
    """The states seeded from a first gradient (the eigh on the host)."""
    return seed_opt_state(states, _grads(leaves, states, gen), fns.groups, fns.hp_weight)


def _parent_update(grads, states, params, lr, groups, hp_weight, hp_latent, refresh):
    """The update as PhaseFns.step made it before soap_step_all: the WEIGHT
    group's global-norm clip, then soap_step_leaf a leaf."""
    sq = sum(torch.square(g).flatten(1).sum(dim=1)
             for g, grp in zip(grads, groups) if grp == WEIGHT)
    norm = torch.sqrt(sq)
    clip = torch.minimum(torch.ones_like(norm), 0.1 / (norm + 1e-6))
    new_p, new_s = [], []
    for p, g, s, grp in zip(params, grads, states, groups):
        if grp == FROZEN or s is None:
            new_p.append(p)
            new_s.append(s)
            continue
        if grp == WEIGHT:
            g = g * clip.reshape((-1,) + (1,) * (g.dim() - 1))
            p2, s2 = soap_step_leaf(g, s, p, lr, hp_weight, refresh=refresh)
        else:
            p2, s2 = soap_step_leaf(g, s, p, lr, hp_latent, refresh=False)
        new_p.append(p2.detach())
        new_s.append(s2)
    return new_p, new_s


def _same_tensor(a, b) -> bool:
    return a.dtype == b.dtype and a.stride() == b.stride() and torch.equal(a, b)


def _assert_same(got, want):
    """Two updates' (params, states) equal bit for bit and laid out alike,
    None where None."""
    (gp, gs), (wp, ws) = got, want
    assert len(gp) == len(wp) and len(gs) == len(ws)
    assert all(_same_tensor(a, b) for a, b in zip(gp, wp))
    for a, b in zip(gs, ws):
        assert (a is None) == (b is None)
        if a is None:
            continue
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert _same_tensor(a[k], b[k]), k
        for k in ("GG", "Q"):
            assert [x is None for x in a[k]] == [x is None for x in b[k]]
            assert all(x is None or _same_tensor(x, y) for x, y in zip(a[k], b[k])), k


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("op", ["hop", "lop"])
def test_update_is_the_parents_loop(op, G, refresh):
    fcfg, fns, leaves, states = _fns(op, G, SIZE, "cpu")
    gen = torch.Generator().manual_seed(G * 10 + len(op))
    states = _seeded(fns, leaves, states, gen)
    lr = torch.tensor(1e-2)
    args = (fns.groups, fns.hp_weight, fns.hp_latent)
    # carry the state through a refresh first: the QR's Q, GG and moments
    # as a step meets them later in a window
    for k in range(2):
        leaves, states = _parent_update(_grads(leaves, states, gen), states, leaves, lr, *args,
                                        refresh=k == 1)
    grads = _grads(leaves, states, gen)
    got = soap_step_all(grads, states, leaves, lr, *args, refresh=refresh)
    _assert_same(got, _parent_update(grads, states, leaves, lr, *args, refresh=refresh))
    frozen = [i for i, grp in enumerate(fns.groups) if grp == FROZEN]
    assert frozen and all(got[0][i] is leaves[i] and got[1][i] is None for i in frozen)

    # the trainer's step on the CPU: every update eager, nothing captured
    target = torch.rand((G, 3, *SIZE), generator=gen)
    noise = TorchNoise(gen)
    level, lmbda = torch.full((G,), 0.2), torch.full((G,), 1e-3)
    with trace.collect() as rec:
        for k in range(2):
            leaves, states = fns.step(leaves, states,
                                      noise("step", fcfg, G, "gaussian", level, True), 0.3, lr,
                                      target, lmbda, refresh=refresh and k == 1)
    assert rec.counters == {"train.soap.eager_steps": 2}
    assert fns.update.graphs == {}


class _StandInGraph:
    """A CUDA graph's stand-in on the CPU: replay() reruns the function
    into the static outputs the capture made."""

    def replay(self):
        self.rerun()


@pytest.mark.parametrize("op", ["hop", "lop"])
def test_replay_buffers_on_a_stand_in_graph(op, monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(soap.SoapUpdate, "_stream", lambda self, dev: None)
    _, fns, leaves, states = _fns(op, 2, SIZE, "cpu")
    upd = fns.update
    gen = torch.Generator().manual_seed(5)
    states = _seeded(fns, leaves, states, gen)
    lr = torch.tensor(1e-2)
    live = [i for i, grp in enumerate(upd.groups) if grp != FROZEN]
    flat_of = lambda g, s, p: ([g[i] for i in live] + [p[i] for i in live]  # noqa: E731
                               + [t for i in live for t in soap._state_tensors(s[i])])
    c, returned = None, []
    for _ in range(6):
        grads = _grads(leaves, states, gen)
        want = upd.eager(grads, states, leaves, lr, refresh=False)
        flat = flat_of(grads, states, leaves)
        if c is None:
            c = upd._capture(torch.device("cpu"), live, states, flat, lr)

            def rerun(c=c, like=states):
                p, s = upd._run(live, like, c.ins, c.lr)
                for out, new in zip(c.outs, p + [t for x in s for t in soap._state_tensors(x)]):
                    out.copy_(new)

            c.graph.rerun = rerun
        got = upd._replay(c, live, states, leaves, flat, lr)
        _assert_same(got, want)
        statics = {t.data_ptr() for t in c.outs + c.ins}
        for i in live:
            # Q comes back as the caller's own tensor; nothing else is a
            # static buffer of the graph
            assert all(x is y for x, y in zip(got[1][i]["Q"], states[i]["Q"]))
            assert got[0][i].data_ptr() not in statics
            assert got[1][i]["exp_avg"].data_ptr() not in statics
        assert all(got[0][i] is leaves[i] for i in range(len(leaves)) if i not in live)
        returned.append((got[0], [p.clone() for p in got[0]]))
        leaves, states = got
    # what a step returned is not written by the later replays
    assert all(torch.equal(a, b) for ps, kept in returned for a, b in zip(ps, kept))


# ---------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


CARD = {"hop.b8": ("hop", 8), "lop.b1": ("lop", 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD))
def test_replays_equal_the_eager_update(case):
    dev = _card()
    op, G = CARD[case]
    _, fns, leaves, states = _fns(op, G, (512, 768), dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    states = _seeded(fns, leaves, states, gen)
    lr = torch.tensor(1e-2, device=dev)
    with trace.collect() as rec:
        for k in range(1, 2 * PF + 1):
            grads = _grads(leaves, states, gen)
            want = fns.update.eager(grads, states, leaves, lr, refresh=k % PF == 0)
            got = fns.update(grads, states, leaves, lr, refresh=k % PF == 0)
            _assert_same(got, want)
            leaves, states = got
    c = rec.counters
    print(f"{case}: {c}")
    # the refresh steps and one warm-up a key eager, every other step replayed
    captures = c["train.soap.captures"]
    assert captures in (1, 2)
    assert c["train.soap.eager_steps"] == 2 + captures
    assert c["train.soap.graph_replays"] == 2 * PF - 2 - captures


@pytest.mark.cuda
def test_returned_tensors_survive_later_replays():
    dev = _card()
    _, fns, leaves, states = _fns("lop", 1, (512, 768), dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    states = _seeded(fns, leaves, states, gen)
    lr = torch.tensor(1e-2, device=dev)
    for _ in range(3):                       # warm-up, capture, a replay
        leaves, states = fns.update(_grads(leaves, states, gen), states, leaves, lr,
                                    refresh=False)
    kept_p, kept_s = leaves, states
    clone_p = [p.clone() for p in kept_p]
    clone_s = [None if s is None else {k: s[k].clone() for k in ("step", "exp_avg", "exp_avg_sq")}
               for s in kept_s]
    with trace.collect() as rec:
        for _ in range(5):
            leaves, states = fns.update(_grads(leaves, states, gen), states, leaves, lr,
                                        refresh=False)
    assert rec.counters == {"train.soap.graph_replays": 5}
    assert all(torch.equal(a, b) for a, b in zip(kept_p, clone_p))
    for s, c in zip(kept_s, clone_s):
        assert (s is None) == (c is None)
        assert c is None or all(torch.equal(s[k], c[k]) for k in c)


@pytest.mark.cuda
def test_new_shapes_capture_anew():
    dev = _card()
    lr = torch.tensor(1e-2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    _, fns, leaves, states = _fns("lop", 2, (64, 96), dev)
    _, _, leaves3, states3 = _fns("lop", 3, (64, 96), dev)
    with trace.collect() as rec:
        for lv, st in ((leaves, states), (leaves3, states3)):
            st = _seeded(fns, lv, st, gen)
            for _ in range(3):                # warm-up, capture, a replay
                lv, st = fns.update(_grads(lv, st, gen), st, lv, lr, refresh=False)
    assert rec.counters == {"train.soap.eager_steps": 2, "train.soap.captures": 2,
                            "train.soap.graph_replays": 4}
    assert sum(c is not None for c in fns.update.graphs.values()) == 2


@pytest.mark.cuda
def test_data_mesh_replays_on_both_chunks():
    dev = _card()
    size = (64, 96)
    fcfg = FrameConfig(coolchic_cfg={"residue": coolchic_config_from_args(
        intra_operating_points()["lop"], size)})
    phase = TrainerPhase(lmbda=1e-3, precondition_frequency_model=PF)
    params, opt = batched_init(fcfg, phase, 4, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    targets = torch.rand((4, 3, *size), generator=gen, device=dev)
    keys = [torch.Generator(device=dev).manual_seed(20 + i) for i in range(4)]
    window = make_batched_window(fcfg, phase_key(phase), 3,
                                 make_mesh(devices=["cuda:0", "cuda:0"]))
    with trace.collect() as rec:
        params2, opt2, _ = window(params, opt, keys, 1e-2, 0.3, 0.2, targets)
    # the first chunk's first step warms the graph up, the second chunk's
    # captures it; every later step of either chunk replays it
    soap_counters = {k: v for k, v in rec.counters.items() if k.startswith("train.soap.")}
    assert soap_counters == {"train.soap.eager_steps": 1, "train.soap.captures": 1,
                             "train.soap.graph_replays": 5}
    assert all(torch.isfinite(x).all() for x in tree_leaves(params2))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(params2), tree_leaves(params)))
