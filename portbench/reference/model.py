"""Plain float Cool-Chic of one image, in torch: the quantization proxy,
the ARM rate with its IFCE context, the learned upsampling and the
synthesis. Written from the architecture's description (Cool-Chic 5.0.1),
one image at a time, with torch's conv ops where the program uses
matrix products; shared by the decode and training references.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MASK, PAD = 9, 4
GAIN = 16                        # encoder gain on the latents
LOG_SHIFT, LOG_MIN, LOG_MAX = -4.0, -5.0, 5.0
MIN_PROBA = 2.0 ** -16
PRIORITY_ORDER = np.array([
    38, 35, 30, 25, 23, 31, 36, 37, 39, 33, 28, 21, 20, 6, 15, 22, 29, 34,
    32, 18, 12, 10, 5, 9, 14, 19, 27, 24, 13, 8, 2, 1, 3, 11, 17, 26,
    16, 7, 4, 0])


def ctx_index(n_spatial: int) -> np.ndarray:
    """Flat 9x9 indices of the first n causal context pixels, in ARM input
    order (the format's priority table)."""
    return np.arange(40)[np.argsort(PRIORITY_ORDER, kind="stable")][:n_spatial]


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def softround(x: torch.Tensor, t: float) -> torch.Tensor:
    f = torch.floor(x)
    return f + 0.5 * torch.tanh((x - f - 0.5) / t) / np.tanh(1.0 / (2.0 * t)) + 0.5


def full_kernel(half: torch.Tensor, k: int) -> torch.Tensor:
    """The symmetric 1-D kernel of size k from its (k + 1) // 2 first taps."""
    tail = half.flip(0) if k % 2 == 0 else half[:-1].flip(0)
    return torch.cat([half, tail])


def upsample(grids: list[torch.Tensor], tconv: list, conv: list, k_up: int,
             k_pre: int) -> torch.Tensor:
    """Learned pyramid upsampling of one image's grids ([h_i, w_i], largest
    first) -> [C, H, W]: per x2 step a replicate-padded stride-2 transposed
    conv with the symmetric kernel, cropped, beside the finer grid filtered
    by a zero-padded symmetric conv plus itself."""
    rev = list(reversed(grids))
    acc = rev[0][None]
    for idx, target in enumerate(rev[1:]):
        j = idx % len(tconv)
        kt = full_kernel(tconv[j], k_up)
        p0 = k_up // 2
        crop = 2 * p0 - 1 + k_up // 2
        x = F.pad(acc[:, None], (p0, p0, p0, p0), mode="replicate")
        x = F.conv_transpose2d(x, torch.outer(kt, kt)[None, None], stride=2)[:, 0]
        x = x[:, crop:crop + target.shape[-2], crop:crop + target.shape[-1]]
        kp = full_kernel(conv[j], k_pre)
        high = F.conv2d(target[None, None], torch.outer(kp, kp)[None, None],
                        padding=k_pre // 2)[0] + target[None]
        acc = torch.cat([high, x], dim=0)
    return acc


def synthesize(x: torch.Tensor, syn: dict, specs) -> torch.Tensor:
    """[C_in, H, W] -> [C_out, H, W]: replicate-padded convs, residual adds,
    the linear stabiliser over the input, the output transform."""
    def conv(y, lay):
        p = (lay["weight"].shape[-1] - 1) // 2
        if p:
            y = F.pad(y[None], (p, p, p, p), mode="replicate")[0]
        return F.conv2d(y[None], lay["weight"], lay["bias"])[0]

    y = x
    for lay, (_, _, mode, nl) in zip(syn["layers"], specs):
        z = conv(y, lay)
        if mode == "residual":
            z = z + y
        y = torch.relu(z) if nl == "relu" else z
    if "stabiliser" in syn:
        y = y + conv(x[:syn["stabiliser"]["weight"].shape[1]], syn["stabiliser"])
    return conv(y, syn["output_transform"])


def _linear(x, lay):
    return x @ lay["weight"].T + lay["bias"]


def arm(params: dict, x: torch.Tensor) -> torch.Tensor:
    """[B, C] contexts -> [B, n_out]: residual ReLU hidden layers, the last
    linear layer, and the linear stabiliser when there is one."""
    y = x
    for lay in params["layers"][:-1]:
        y = torch.relu(_linear(y, lay) + y)
    y = _linear(y, params["layers"][-1])
    if "stabiliser" in params:
        y = y + _linear(x, params["stabiliser"])
    return y


def spatial_context(grid: torch.Tensor, n_spatial: int) -> torch.Tensor:
    """[h, w] -> [h * w, n_spatial] causal contexts (zeros outside)."""
    cols = F.unfold(grid[None, None], MASK, padding=PAD)[0]       # [81, h * w]
    return cols[torch.as_tensor(ctx_index(n_spatial), device=grid.device)].T


def _nearest_x2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def ifce_context(ifce: dict, cfg, grids: list[torch.Tensor], i: int) -> torch.Tensor:
    """[h_i * w_i, C_f] context of grid i from the coarser grids."""
    h, w = grids[i].shape
    if cfg.input_features_ifce[i] == 0:
        return grids[i].new_zeros((h * w, cfg.output_feature_ifce))
    coarser = list(reversed(grids[i + 1:]))
    acc = coarser[0][None]
    for target in coarser[1:]:
        x = acc
        if acc.shape[-2:] != target.shape[-2:]:
            x = _nearest_x2(acc)[..., :target.shape[-2], :target.shape[-1]]
        acc = torch.cat([target[None], x], dim=0)
    c, hc, wc = acc.shape
    k = sum(1 for n in cfg.input_features_ifce[:i] if n)
    ctx = arm(ifce["arms"][k], acc.reshape(c, -1).T)                # [hc * wc, C_f]
    ctx = _nearest_x2(ctx.T.reshape(-1, hc, wc))[:, :h, :w]
    return ctx.reshape(-1, h * w).T


def laplace_cdf(x, mu, b):
    s = x - mu
    return 0.5 - 0.5 * torch.sign(s) * torch.expm1(-torch.abs(s) / b)


def rate_bits(params: dict, cfg, grids: list[torch.Tensor]) -> torch.Tensor:
    """Total rate in bits of the quantized grids under the ARM."""
    total = grids[0].new_zeros(())
    for i, g in enumerate(grids):
        ctx = spatial_context(g, cfg.spatial_context_arm)
        if cfg.flag_ifce:
            ctx = torch.cat([ctx, ifce_context(params["ifce"], cfg, grids, i)], dim=1)
        out = arm(params["arm"], ctx)
        mu, b = out[:, 0], torch.exp(clip(out[:, 1] + LOG_SHIFT, LOG_MIN, LOG_MAX))
        x = g.reshape(-1)
        p = laplace_cdf(x + 0.5, mu, b) - laplace_cdf(x - 0.5, mu, b)
        total = total + (-torch.log2(torch.maximum(p, p.new_full((), MIN_PROBA)))).sum()
    return total
