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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


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
