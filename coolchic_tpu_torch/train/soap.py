"""SOAP optimizer (Shampoo-eigenbasis Adam, arXiv:2409.11321) on tensors.

A port of the JAX package's re-derivation (coolchic_tpu/train/soap.py),
which follows the implementation the reference vendors
(coolchic/training/soap.py, MIT, Nikhil Vyas): Adam runs in the eigenbasis
of per-dimension gradient-covariance (GG) matrices; the eigenbasis is
refreshed every `precondition_frequency` steps with one power iteration +
QR; the very first step only initializes the preconditioner (no parameter
update).

With max_precond_dim=0 every dimension is excluded and the transform reduces
to plain Adam -- how the reference trains the latent grids (betas
(0.9, 0.999), wd 0) next to the SOAP'd network weights (betas (0.95, 0.95),
wd 0.01).

Every tensor carries a leading batch axis of G images: a parameter leaf is
[G, *shape], its GG and Q matrices [G, d, d], its step [G]. One state dict
per leaf: {"step", "exp_avg", "exp_avg_sq", "GG": [per dim], "Q": [per
dim]}, with None for a dimension that is not preconditioned.

soap_step_all is one training step's update of every leaf (the weight
group's clip, then a step a leaf); SoapUpdate runs it for a trainer, on a
card as the replay of a CUDA graph on the steps without a refresh.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from coolchic_tpu_torch.train.params import FROZEN, WEIGHT
from coolchic_tpu_torch.utils import trace


@dataclass(frozen=True)
class SoapHyperParams:
    b1: float = 0.95
    b2: float = 0.95
    shampoo_beta: float = -1.0  # < 0 -> use b2
    eps: float = 1e-8
    weight_decay: float = 0.01
    precondition_frequency: int = 10
    max_precond_dim: int = 10000
    precondition_1d: bool = False
    correct_bias: bool = True

    @property
    def effective_shampoo_beta(self) -> float:
        return self.shampoo_beta if self.shampoo_beta >= 0 else self.b2


def _precond_dims(shape: tuple[int, ...], hp: SoapHyperParams) -> tuple[bool, ...]:
    """Which dimensions (of one image's leaf shape) get a GG/Q matrix."""
    if len(shape) == 1:
        return (hp.precondition_1d and shape[0] <= hp.max_precond_dim,)
    return tuple(s <= hp.max_precond_dim for s in shape)


def _contract_first(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per image, jnp.tensordot(x, q, axes=[[0], [0]]): contract the first
    (non-batch) axis of x [G, d, ...] with q [G, d, e]; the new axis comes
    last."""
    xm = x.movedim(1, -1)
    y = torch.matmul(xm.reshape(xm.shape[0], -1, xm.shape[-1]), q)
    return y.reshape(*xm.shape[:-1], q.shape[-1])


def _project(x: torch.Tensor, qs: list, active: tuple[bool, ...]) -> torch.Tensor:
    """Into the eigenbasis: contract with Q along each active dim (cyclic
    permute otherwise)."""
    for q, a in zip(qs, active):
        x = _contract_first(x, q) if a else x.movedim(1, -1)
    return x


def _project_back(x: torch.Tensor, qs: list, active: tuple[bool, ...]) -> torch.Tensor:
    for q, a in zip(qs, active):
        x = _contract_first(x, q.transpose(1, 2)) if a else x.movedim(1, -1)
    return x


def _outer_along(g: torch.Tensor, idx: int) -> torch.Tensor:
    """Per image, the [d, d] covariance of g along its dim idx."""
    gm = g.movedim(1 + idx, -1)
    gm = gm.reshape(gm.shape[0], -1, gm.shape[-1])
    return torch.matmul(gm.transpose(1, 2), gm)


def soap_init_leaf(param: torch.Tensor, hp: SoapHyperParams) -> dict[str, Any]:
    """Fresh state of a [G, *shape] leaf."""
    G = param.shape[0]
    active = _precond_dims(tuple(param.shape[1:]), hp)
    eye = lambda d: torch.eye(d, dtype=param.dtype, device=param.device).expand(G, d, d)  # noqa: E731
    return {
        "step": torch.zeros((G,), dtype=torch.int32, device=param.device),
        "exp_avg": torch.zeros_like(param),
        "exp_avg_sq": torch.zeros_like(param),
        "GG": [param.new_zeros((G, d, d)) if a else None
               for d, a in zip(param.shape[1:], active)],
        "Q": [eye(d).clone() if a else None for d, a in zip(param.shape[1:], active)],
    }


def _update_gg(gg_list, grad: torch.Tensor, active, shampoo_beta: float):
    out = []
    for i, (gg, a) in enumerate(zip(gg_list, active)):
        out.append(gg + (1.0 - shampoo_beta) * (_outer_along(grad, i) - gg) if a else gg)
    return out


def _qr_refresh(gg_list, q_list, exp_avg_sq: torch.Tensor, active):
    """One power iteration + QR, sorting by estimated eigenvalues (and
    permuting exp_avg_sq accordingly, as the reference does). The sort is
    stable, as jnp.argsort, so ties keep JAX's order."""
    new_qs = []
    for ind, (m, o, a) in enumerate(zip(gg_list, q_list, active)):
        if not a:
            new_qs.append(o)
            continue
        est_eig = torch.diagonal(o.transpose(1, 2) @ m @ o, dim1=1, dim2=2)
        sort_idx = torch.argsort(-est_eig, dim=1, stable=True)      # [G, d]
        shape = [1] * exp_avg_sq.dim()
        shape[0], shape[ind + 1] = sort_idx.shape
        exp_avg_sq = torch.gather(exp_avg_sq, ind + 1,
                                  sort_idx.reshape(shape).expand_as(exp_avg_sq))
        o = torch.gather(o, 2, sort_idx[:, None, :].expand_as(o))
        q, _ = torch.linalg.qr(m @ o)
        new_qs.append(q)
    return new_qs, exp_avg_sq


def soap_init_from_grad_leaf(grad, state: dict, hp: SoapHyperParams) -> dict:
    """The reference's first step (soap.py:254-297, step:163-182): seed GG
    with the first gradient's covariances, set Q to their eigh eigenbasis
    (eigenvalues descending), make NO parameter update.

    Runs once per phase on the HOST with numpy's eigh, image by image, as
    the JAX package does (only the small weight-leaf gradients cross); the
    results go back to the state's device."""
    g_all = np.asarray(grad.detach().cpu() if torch.is_tensor(grad) else grad,
                       dtype=np.float32)
    active = _precond_dims(g_all.shape[1:], hp)
    beta = hp.effective_shampoo_beta
    new_gg, new_q = [], []
    for i, (gg, a) in enumerate(zip(state["GG"], active)):
        if not a:
            new_gg.append(gg)
            new_q.append(state["Q"][i])
            continue
        gg_host = gg.detach().cpu().numpy()
        gg_out, q_out = [], []
        for n, g in enumerate(g_all):
            axes = list(range(g.ndim))
            axes.remove(i)
            outer = np.tensordot(g, g, axes=(axes, axes))
            gg_np = np.asarray(gg_host[n], np.float32) * beta + (1.0 - beta) * outer
            _, q = np.linalg.eigh(gg_np + 1e-30 * np.eye(gg_np.shape[0],
                                                         dtype=np.float32))
            gg_out.append(gg_np)
            q_out.append(np.flip(q, axis=1).copy())
        new_gg.append(torch.as_tensor(np.stack(gg_out), device=gg.device))
        new_q.append(torch.as_tensor(np.stack(q_out), device=gg.device))
    return {**state, "GG": new_gg, "Q": new_q}


def soap_step_leaf(grad: torch.Tensor, state: dict, param: torch.Tensor,
                   lr: torch.Tensor, hp: SoapHyperParams, *,
                   refresh: bool) -> tuple[torch.Tensor, dict]:
    """One (initialized) SOAP step for one [G, *shape] leaf. `lr` is a f32
    tensor (0-d or broadcastable to the leaf); `refresh` runs the QR
    eigenbasis refresh after the update."""
    active = _precond_dims(tuple(param.shape[1:]), hp)
    bshape = (-1,) + (1,) * (param.dim() - 1)

    qs = state["Q"]
    grad_proj = _project(grad, qs, active)
    step = state["step"] + 1
    exp_avg = state["exp_avg"] * hp.b1 + grad_proj * (1.0 - hp.b1)
    exp_avg_sq = state["exp_avg_sq"] * hp.b2 + torch.square(grad_proj) * (1.0 - hp.b2)
    denom = torch.sqrt(exp_avg_sq) + hp.eps

    step_size = lr
    if hp.correct_bias:
        step_f = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(hp.b1, step_f)
        bc2 = 1.0 - torch.pow(hp.b2, step_f)
        step_size = (step_size * torch.sqrt(bc2) / bc1).reshape(bshape)

    norm_grad = _project_back(exp_avg / denom, qs, active)
    new_param = param - step_size * norm_grad
    if hp.weight_decay > 0:
        new_param = new_param - lr * hp.weight_decay * new_param

    gg = _update_gg(state["GG"], grad, active, hp.effective_shampoo_beta)
    if refresh and any(active):
        exp_avg_back = _project_back(exp_avg, qs, active)
        new_qs, exp_avg_sq = _qr_refresh(gg, qs, exp_avg_sq, active)
        exp_avg = _project(exp_avg_back, new_qs, active)
    else:
        new_qs = list(qs)

    return new_param, {"step": step, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq,
                       "GG": gg, "Q": new_qs}


def soap_step_all(grads: list, states: list, params: list, lr: torch.Tensor, groups: list,
                  hp_weight: SoapHyperParams, hp_latent: SoapHyperParams, *,
                  refresh: bool) -> tuple[list, list]:
    """One training step's update of every leaf: the global-norm clip of the
    WEIGHT group's gradients at 0.1, per image (reference train.py:228),
    then soap_step_leaf a leaf: SOAP under hp_weight on the weights (the
    eigenbasis refresh when `refresh`), Adam under hp_latent on the
    latents. A FROZEN leaf, or one with no state, passes through as it is.
    Returns (new_params, new_states), a leaf each."""
    with trace.span("train.clip"):
        sq = sum(torch.square(g).flatten(1).sum(dim=1)
                 for g, grp in zip(grads, groups) if grp == WEIGHT)
        norm = torch.sqrt(sq)
        clip = torch.minimum(torch.ones_like(norm), 0.1 / (norm + 1e-6))
    new_p, new_s = [], []
    with trace.span("train.soap.refresh") if refresh else trace.OFF:
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


def _state_tensors(s) -> list:
    """A leaf's state as a flat list of its tensors (none for no state)."""
    if s is None:
        return []
    return [s["step"], s["exp_avg"], s["exp_avg_sq"],
            *(x for x in s["GG"] if x is not None), *(x for x in s["Q"] if x is not None)]


def _state_like(s, it):
    """The state shaped like `s` (its dimensions without a GG/Q matrix kept
    None) from the next tensors of the iterator `it`."""
    if s is None:
        return None
    return {"step": next(it), "exp_avg": next(it), "exp_avg_sq": next(it),
            "GG": [None if x is None else next(it) for x in s["GG"]],
            "Q": [None if x is None else next(it) for x in s["Q"]]}


_NEW = object()     # SoapUpdate.graphs' answer for a key not seen yet
_SIZE, _STRIDE, _DTYPE = torch.Tensor.size, torch.Tensor.stride, operator.attrgetter("dtype")


def _by_dtype(tensors: list, where: list) -> list:
    """[(tensors, their positions)] a dtype: multi-tensor copies take one
    dtype a list (a list that mixes them falls back to a copy a tensor)."""
    groups: dict = {}
    for t, k in zip(tensors, where):
        ts, ks = groups.setdefault(t.dtype, ([], []))
        ts.append(t)
        ks.append(k)
    return list(groups.values())


class _Captured:
    """One CUDA graph of soap_step_all and the static tensors it reads and
    writes: the inputs flattened (gradients, parameters, states of the
    leaves that train) and lr; the outputs flattened (parameters, states)
    and the output states' shape; for each output the input it is (a state
    passed through, such as Q on a step without a refresh), or -1; the
    static inputs and the outputs to copy out, a dtype each, with their
    positions."""

    __slots__ = ("graph", "ins", "lr", "outs", "out_states", "alias", "copy_in", "copy_out")

    def __init__(self, graph, ins, lr, outs, out_states, alias):
        self.graph, self.ins, self.lr = graph, ins, lr
        self.outs, self.out_states, self.alias = outs, out_states, alias
        self.copy_in = _by_dtype(ins, range(len(ins)))
        self.copy_out = _by_dtype([t for t, a in zip(outs, alias) if a < 0],
                                  [k for k, a in enumerate(alias) if a < 0])


class SoapUpdate:
    """soap_step_all for one trainer (its leaves' groups and both groups'
    hyper-parameters), as the trainer calls it each step.

    On the CPU, and on a step with the eigenbasis refresh (its QR stays
    eager), it calls soap_step_all. On a card, a step without a refresh
    replays a CUDA graph of soap_step_all: one launch in place of about
    36 small kernels a leaf, which the host would dispatch one by one. The
    graph reads static copies of the step's inputs (copied in with
    multi-tensor copies) and its outputs are copied out into fresh tensors,
    so that no tensor returned to the caller is written by a later replay;
    a state passed through (Q) comes back as the caller's own tensor, as
    from soap_step_all. Graphs are kept by device and by the inputs'
    shapes, strides and dtypes (the strides, so that a product reads its
    operands laid out as the eager step would); the first step of a new
    key runs soap_step_all eagerly on a side stream (its warm-up, as
    torch.cuda.graphs asks), the next one captures. The graphs' memory
    pools go with the instance.

    Counters: train.soap.eager_steps, train.soap.captures and
    train.soap.graph_replays (a capture's step is a replay too)."""

    def __init__(self, groups: list, hp_weight: SoapHyperParams, hp_latent: SoapHyperParams):
        self.groups = list(groups)
        self.hp_weight, self.hp_latent = hp_weight, hp_latent
        self.graphs: dict = {}      # key -> None once warmed up, then its _Captured
        self._streams: dict = {}    # device -> the side stream of warm-ups and captures

    def eager(self, grads: list, states: list, params: list, lr: torch.Tensor, *,
              refresh: bool) -> tuple[list, list]:
        return soap_step_all(grads, states, params, lr, self.groups, self.hp_weight,
                             self.hp_latent, refresh=refresh)

    def __call__(self, grads: list, states: list, params: list, lr: torch.Tensor, *,
                 refresh: bool) -> tuple[list, list]:
        live = [i for i, grp in enumerate(self.groups) if grp != FROZEN]
        dev = params[live[0]].device if live else None
        if refresh or dev is None or dev.type != "cuda":
            trace.count("train.soap.eager_steps", 1)
            return self.eager(grads, states, params, lr, refresh=refresh)
        flat = ([grads[i] for i in live] + [params[i] for i in live]
                + [t for i in live for t in _state_tensors(states[i])])
        key = (dev, lr.shape, lr.dtype, tuple(states[i] is None for i in live),
               tuple(map(_SIZE, flat)), tuple(map(_STRIDE, flat)), tuple(map(_DTYPE, flat)))
        with torch.cuda.device(dev):
            c = self.graphs.get(key, _NEW)
            if c is _NEW:
                self.graphs[key] = None
                trace.count("train.soap.eager_steps", 1)
                return self._warm_up(dev, grads, states, params, lr)
            if c is None:
                c = self.graphs[key] = self._capture(dev, live, states, flat, lr)
                trace.count("train.soap.captures", 1)
            trace.count("train.soap.graph_replays", 1)
            return self._replay(c, live, states, params, flat, lr)

    def _stream(self, dev: torch.device) -> torch.cuda.Stream:
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def _warm_up(self, dev, grads, states, params, lr) -> tuple[list, list]:
        """The eager step on the side stream, ordered after the caller's
        work and before what the caller queues next."""
        side, cur = self._stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.eager(grads, states, params, lr, refresh=False)
        cur.wait_stream(side)
        return out

    def _run(self, live: list, states: list, ins: list, lr) -> tuple[list, list]:
        """soap_step_all over the leaves that train, from their flat inputs."""
        n = len(live)
        it = iter(ins[2 * n:])
        return soap_step_all(ins[:n], [_state_like(states[i], it) for i in live], ins[n:2 * n],
                             lr, [self.groups[i] for i in live], self.hp_weight,
                             self.hp_latent, refresh=False)

    def _capture(self, dev, live, states, flat, lr) -> _Captured:
        ins = [torch.empty_like(t) for t in flat]
        lr_in = torch.empty_like(lr, device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream(dev)):
            new_p, new_s = self._run(live, states, ins, lr_in)
        outs = new_p + [t for s in new_s for t in _state_tensors(s)]
        where = {id(t): k for k, t in enumerate(ins)}
        return _Captured(graph, ins, lr_in, outs, new_s, [where.get(id(t), -1) for t in outs])

    def _replay(self, c: _Captured, live, states, params, flat, lr) -> tuple[list, list]:
        for dst, where in c.copy_in:
            torch._foreach_copy_(dst, [flat[k] for k in where])
        c.lr.copy_(lr)
        c.graph.replay()
        outs = [flat[a] if a >= 0 else None for a in c.alias]
        for src, where in c.copy_out:
            # fresh tensors, laid out as the static ones: x * 1 is x exactly,
            # and one multi-tensor op allocates them all in C++
            for k, t in zip(where, torch._foreach_mul(src, 1)):
                outs[k] = t
        outs = iter(outs)
        new_p, new_s = list(params), list(states)
        for i in live:
            new_p[i] = next(outs)
        for i, s in zip(live, c.out_states):
            new_s[i] = _state_like(s, outs)
        return new_p, new_s
