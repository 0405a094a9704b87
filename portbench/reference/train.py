"""Plain training of one image's Cool-Chic: the rate-distortion loss,
autograd gradients, the weight group's global-norm clip and SOAP (Adam in
the eigenbasis of each weight's gradient covariances, refreshed by one
power iteration and QR every `precondition_frequency` steps; plain Adam
for the latents), written per image from arXiv:2409.11321 and Cool-Chic
5.0.1's training recipe. The benchmark's reference for the encode cells.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model

LATENT, WEIGHT, FROZEN = "latent", "weight", "frozen"


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(path, leaf) pairs, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in flatten(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in flatten(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def group(path: str) -> str:
    if "latents" in path:
        return LATENT
    if "output_transform" in path or "global_flow" in path:
        return FROZEN
    return WEIGHT


def unflatten(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: unflatten(v, leaves, f"{prefix}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [unflatten(v, leaves, f"{prefix}/{i}") for i, v in enumerate(like)]
    return leaves[prefix]


def loss_fn(p: dict, cfg, target: torch.Tensor, lmbda: float, noise: list, temp: float):
    """MSE + lambda * rate / pixels of one image's params (`p` holds the
    cool-chic's tree: latents, arm, ifce, upsampling, synthesis)."""
    grids = [model.softround(model.softround(lat * model.GAIN, temp) + n, temp)
             for lat, n in zip(p["latents"], noise)]
    rate = model.rate_bits(p, cfg, grids)
    syn_in = [g for g, hyper in zip(grids, cfg.flag_is_hyperlatent) if not hyper]
    ups = p["upsampling"]
    dense = model.upsample(syn_in, ups["tconv_half"], ups["conv_half"], cfg.ups_k_size,
                           cfg.ups_preconcat_k_size)
    decoded = model.clip(model.synthesize(dense, p["synthesis"], cfg.parsed_synthesis),
                         0.0, 1.0)
    mse = torch.mean((decoded - target) ** 2)
    return mse + lmbda * rate / (target.shape[-2] * target.shape[-1])


class Soap:
    """One leaf's SOAP state. max_dim 0 (the latents) is plain Adam."""

    def __init__(self, p: torch.Tensor, b1: float, b2: float, wd: float, max_dim: int):
        self.b1, self.b2, self.wd = b1, b2, wd
        self.active = [p.dim() > 1 and d <= max_dim for d in p.shape]
        self.step = 0
        self.m = torch.zeros_like(p)
        self.v = torch.zeros_like(p)
        self.gg = [p.new_zeros((d, d)) if a else None for d, a in zip(p.shape, self.active)]
        self.q = [None] * p.dim()

    @staticmethod
    def _outer(g: torch.Tensor, i: int) -> torch.Tensor:
        x = g.movedim(i, -1).reshape(-1, g.shape[i])
        return x.T @ x

    def _rotate(self, x: torch.Tensor, back: bool) -> torch.Tensor:
        for q, a in zip(self.q, self.active):
            x = torch.tensordot(x, q.T if back else q, dims=([0], [0])) if a \
                else x.movedim(0, -1)
        return x

    def seed(self, g: torch.Tensor) -> None:
        """The first gradient's covariances and their eigenbases (numpy's
        eigh in float32, eigenvalues descending); no update."""
        gn = g.detach().cpu().numpy().astype(np.float32)
        for i, a in enumerate(self.active):
            if not a:
                continue
            axes = [k for k in range(gn.ndim) if k != i]
            gg = (1.0 - self.b2) * np.tensordot(gn, gn, axes=(axes, axes)).astype(np.float32)
            _, vec = np.linalg.eigh(gg + np.float32(1e-30) * np.eye(gg.shape[0],
                                                                     dtype=np.float32))
            self.gg[i] = torch.as_tensor(gg, device=g.device)
            self.q[i] = torch.as_tensor(np.flip(vec, axis=1).copy(), device=g.device)

    def update(self, p: torch.Tensor, g: torch.Tensor, lr: float, refresh: bool) -> torch.Tensor:
        if any(self.active) and self.q[self.active.index(True)] is None:
            self.q = [torch.eye(d, device=p.device) if a else None
                      for d, a in zip(p.shape, self.active)]
        rotated = any(self.active)
        gp = self._rotate(g, False) if rotated else g
        self.step += 1
        self.m = self.b1 * self.m + (1.0 - self.b1) * gp
        self.v = self.b2 * self.v + (1.0 - self.b2) * gp * gp
        size = lr * np.sqrt(1.0 - self.b2 ** self.step) / (1.0 - self.b1 ** self.step)
        upd = self.m / (torch.sqrt(self.v) + 1e-8)
        p = p - size * (self._rotate(upd, True) if rotated else upd)
        if self.wd > 0:
            p = p - lr * self.wd * p
        for i, a in enumerate(self.active):
            if a:
                self.gg[i] = self.gg[i] + (1.0 - self.b2) * (self._outer(g, i) - self.gg[i])
        if refresh and rotated:
            m_back = self._rotate(self.m, True)
            for i, a in enumerate(self.active):
                if not a:
                    continue
                est = torch.diagonal(self.q[i].T @ self.gg[i] @ self.q[i])
                order = torch.argsort(-est, stable=True)
                self.v = self.v.index_select(i, order)
                self.q[i] = torch.linalg.qr(self.gg[i] @ self.q[i][:, order])[0]
            self.m = self._rotate(m_back, False)
        return p


def train_steps(params: dict, cfg, target: torch.Tensor, lmbda: float, seed_noise: list,
                noises: list[list], temp: float, lr: float, pf: int, hp: dict) -> dict:
    """SOAP seeding from one gradient, then len(noises) steps of one image.
    `params`: {path: tensor} of the cool-chic's leaves (the frame's
    "/residue/..." paths and its frozen leaves); returns the loss of each
    step, each leaf's first clipped gradient norm and each leaf's change
    after the last step."""
    like = {}
    for path in params:
        node = like
        keys = path.strip("/").split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = path
    like = _lists(like)
    cc = "residue"
    paths = [p for p in params if group(p) != FROZEN]
    state = {p: Soap(params[p], *(hp["weight"] if group(p) == WEIGHT else hp["latent"]))
             for p in paths}

    def grads(cur: dict, noise: list):
        req = {p: (v.detach().requires_grad_(True) if p in state else v)
               for p, v in cur.items()}
        tree = unflatten(like, req)
        lo = loss_fn(tree[cc], cfg, target, lmbda, noise, temp)
        gs = torch.autograd.grad(lo, [req[p] for p in paths], allow_unused=True)
        return lo.detach(), {p: torch.zeros_like(req[p]) if g is None else g
                             for p, g in zip(paths, gs)}

    _, g0 = grads(params, seed_noise)
    for p in paths:
        if group(p) == WEIGHT:
            state[p].seed(g0[p])
    cur = dict(params)
    losses, first = [], {}
    for s, noise in enumerate(noises):
        lo, g = grads(cur, noise)
        losses.append(float(lo))
        norm = torch.sqrt(sum(torch.sum(g[p] ** 2) for p in paths if group(p) == WEIGHT))
        clip = torch.clamp(0.1 / (norm + 1e-6), max=1.0)
        for p in paths:
            gp = g[p] * clip if group(p) == WEIGHT else g[p]
            if s == 0:
                first[p] = float(torch.linalg.vector_norm(gp))
            cur[p] = state[p].update(cur[p], gp, lr, refresh=(s + 1) % pf == 0).detach()
    change = {p: float(torch.linalg.vector_norm(cur[p] - params[p])) for p in paths}
    return {"losses": losses, "first_grad": first, "change": change}


def _lists(node):
    """Dicts keyed "0", "1", ... back to lists."""
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
