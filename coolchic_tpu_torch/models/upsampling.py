"""Learned pyramid upsampling with symmetric separable kernels.

Each x2 step applies (a) a transposed conv with an even symmetric separable
kernel to the accumulated coarse stack and (b) an odd symmetric separable
residual pre-filter to the higher-resolution grid before concatenation.
Kernels are parameterized by their half (the bitstream carries (k+1)//2 taps
per filter).

Each 1-D chain (replicate-pad -> stride-2 tconv -> crop, or zero-pad ->
stride-1 conv) is linear in the input and in the half kernel, so it is
y = (sum_t half[t] * B_t) @ x with constant basis matrices B_t: two dense
matmuls per 2-D op, the formulation of coolchic_tpu/models/upsampling.py.
The reference's train (2-D kron) and eval (two 1-D passes) variants are the
same linear operator; the decode uses the train one (codec.py:122-126).

Reference parity: coolchic/component/core/upsampling.py:19-595.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from coolchic_tpu_torch.ops.resize import interpolate_x2


# Half of the symmetric bicubic x2 kernel used as the >=8 taps init
# (normative init constant, reference upsampling.py:266).
_BICUBIC_HALF = np.array([0.0351562, 0.1054687, -0.2617187, -0.8789063], dtype=np.float32)
_BILINEAR_HALF = np.array([0.25, 0.75], dtype=np.float32)


def half_param_size(target_k_size: int) -> int:
    return (target_k_size + 1) // 2


@lru_cache(maxsize=None)
def _tconv_mm_basis(n_in: int, k: int) -> np.ndarray:
    """[hk, 2*n_in, n_in] basis of the 1-D replicate-pad/x2-tconv/crop chain.

    Chain semantics (torch parity, reference upsampling.py:287-345):
    pad p0=k//2 replicate; y[m] = sum_u w[k-1-u] * dilated(x_pad)[m+u-(k-1)];
    crop 2*p0-1+k//2 per side. w is the symmetrized half kernel.
    """
    p0 = k // 2
    crop = 2 * p0 - 1 + k // 2
    hk = (k + 1) // 2
    n_pad = n_in + 2 * p0
    out = np.zeros((hk, 2 * n_in, n_in), dtype=np.float32)
    for m_f in range(2 * n_in):
        m = m_f + crop
        for u in range(k):
            v = m + u - (k - 1)
            if v < 0 or v >= 2 * n_pad - 1 or v % 2:
                continue
            src = min(max(v // 2 - p0, 0), n_in - 1)
            w_idx = k - 1 - u
            t = w_idx if w_idx < hk else k - 1 - w_idx
            out[t, m_f, src] += 1.0
    return out


@lru_cache(maxsize=None)
def _conv_mm_basis(n_in: int, k: int) -> np.ndarray:
    """[hk, n_in, n_in] basis of 1-D zero-padded stride-1 cross-correlation."""
    pad = k // 2
    hk = (k + 1) // 2
    out = np.zeros((hk, n_in, n_in), dtype=np.float32)
    for i in range(n_in):
        for u in range(k):
            j = i + u - pad
            if j < 0 or j >= n_in:
                continue
            t = u if u < hk else k - 1 - u
            out[t, i, j] += 1.0
    return out


@lru_cache(maxsize=64)
def _basis_on(kind: str, n_in: int, k: int, device: torch.device) -> torch.Tensor:
    fn = _tconv_mm_basis if kind == "tconv" else _conv_mm_basis
    return torch.as_tensor(fn(n_in, k), device=device)


def _sep_matrices(half: torch.Tensor, kind: str, sizes: tuple[int, int], k: int):
    """Per-image [G, o, i] matrices of the H and W 1-D chains."""
    bh = _basis_on(kind, sizes[0], k, half.device)
    bw = _basis_on(kind, sizes[1], k, half.device)
    return (torch.einsum("gt,tij->gij", half, bh),
            torch.einsum("gt,tij->gij", half, bw))


def _tconv_x2(x: torch.Tensor, half: torch.Tensor, k: int) -> torch.Tensor:
    """[G, c, H, W] -> [G, c, 2H, 2W] with each image's symmetric kernel
    (half: [G, hk])."""
    th, tw = _sep_matrices(half, "tconv", tuple(x.shape[-2:]), k)
    y = torch.einsum("goh,gchw->gcow", th, x)
    return torch.einsum("gow,gchw->gcho", tw, y)


def _preconcat(x: torch.Tensor, half: torch.Tensor, k: int) -> torch.Tensor:
    """Residual symmetric filtering of [G, 1, H, W] (zero padding)."""
    ch, cw = _sep_matrices(half, "conv", tuple(x.shape[-2:]), k)
    y = torch.einsum("goh,gchw->gcow", ch, x)
    y = torch.einsum("gow,gchw->gcho", cw, y)
    return y + x


class Upsampling(nn.Module):
    """One image's learned upsampling: half kernels per x2 step."""

    def __init__(self, ups_k_size: int, ups_preconcat_k_size: int,
                 tconv_half: list[torch.Tensor], conv_half: list[torch.Tensor]):
        super().__init__()
        self.ups_k_size = ups_k_size
        self.ups_preconcat_k_size = ups_preconcat_k_size
        self.tconv_half = nn.ParameterList(
            [nn.Parameter(t, requires_grad=False) for t in tconv_half])
        self.conv_half = nn.ParameterList(
            [nn.Parameter(t, requires_grad=False) for t in conv_half])

    def forward(self, grids: list[torch.Tensor]) -> torch.Tensor:
        """Grids (largest first, each [H_i, W_i]) -> dense [C, H, W]."""
        return upsampling_batched([self], [g[None] for g in grids])[0]


def upsampling_batched(mods: list[Upsampling], grids: list[torch.Tensor]
                       ) -> torch.Tensor:
    """G images, each with its own Upsampling: latent grids (largest first,
    each [G, H_i, W_i]) -> dense [G, C, H, W] stack."""
    m0 = mods[0]
    return upsampling_apply(
        [torch.stack([m.tconv_half[j] for m in mods]) for j in range(len(m0.tconv_half))],
        [torch.stack([m.conv_half[j] for m in mods]) for j in range(len(m0.conv_half))],
        grids, m0.ups_k_size, m0.ups_preconcat_k_size)


def upsampling_apply(tconv_half: list[torch.Tensor], conv_half: list[torch.Tensor],
                     grids: list[torch.Tensor], ups_k_size: int,
                     ups_preconcat_k_size: int) -> torch.Tensor:
    """Learned upsampling of G images at once, differentiable in the half
    kernels: per x2 step j, tconv_half[j] and conv_half[j] are [G, hk];
    latent grids (largest first, each [G, H_i, W_i]) -> dense [G, C, H, W].
    Output channel c corresponds to input grid c (reference ordering)."""
    n_ups = len(tconv_half)
    rev = list(reversed(grids))
    acc = rev[0][:, None]                                  # [G, 1, h, w]
    for idx, target in enumerate(rev[1:]):
        j = idx % n_ups
        x = _tconv_x2(acc, tconv_half[j], ups_k_size)
        x = x[:, :, : target.shape[-2], : target.shape[-1]]
        high = _preconcat(target[:, None], conv_half[j], ups_preconcat_k_size)
        acc = torch.cat([high, x], dim=1)
    return acc


def upsampling_init(ups_k_size: int, ups_preconcat_k_size: int, n_ups: int,
                    device: torch.device | str = "cpu") -> dict:
    """One image's upsampling params in the JAX package's layout
    (coolchic_tpu/models/upsampling.py:upsampling_init). The biases are
    carried in the bitstream but take no part in the forward."""
    def t(a):
        return torch.as_tensor(a, device=device)

    zero = np.zeros((1,), dtype=np.float32)
    return {
        "tconv_half": [t(tconv_half_init(ups_k_size)) for _ in range(n_ups)],
        "tconv_bias": [t(zero) for _ in range(n_ups)],
        "conv_half": [t(preconcat_half_init(ups_preconcat_k_size)) for _ in range(n_ups)],
        "conv_bias": [t(zero) for _ in range(n_ups)],
    }


def tconv_half_init(k_size: int) -> np.ndarray:
    assert k_size >= 4 and k_size % 2 == 0, f"ups kernel must be even >= 4, got {k_size}"
    core = _BILINEAR_HALF if k_size < 8 else _BICUBIC_HALF
    half = np.zeros((half_param_size(k_size),), dtype=np.float32)
    half[len(half) - len(core):] = core
    return half


def preconcat_half_init(k_size: int) -> np.ndarray:
    assert k_size % 2 == 1, f"preconcat kernel must be odd, got {k_size}"
    half = np.zeros((half_param_size(k_size),), dtype=np.float32)
    half[-1] = 1.0  # Dirac after symmetrization
    return half


def fixed_upsampling(grids: list[torch.Tensor], mode: str = "bicubic") -> torch.Tensor:
    """Non-learned pyramid upsampling (reference upsampling.py:556-595):
    grids largest first, each [H_i, W_i] -> dense [C, H, W] stack."""
    rev = list(reversed(grids))
    acc = rev[0][None]
    for target in rev[1:]:
        if acc.shape[-2:] != target.shape[-2:]:
            x = interpolate_x2(acc, mode)[..., : target.shape[-2], : target.shape[-1]]
        else:
            x = acc
        acc = torch.cat([target[None], x], dim=0)
    return acc
