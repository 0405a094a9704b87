"""Plain decode of `tpu`-profile Cool-Chic files: the benchmark's reference.

Written from the format's definition, not from the program: a numpy range
decoder of the 24-bit integer probability model, run wavefront by
wavefront over every stream of a grid at once and over a batch of
same-architecture images; the X.8 int64 ARM and IFCE; the float tail
(model.py) in float32, TF32 off unless the caller asks for it. Only header
and network parsing are copied (bitparse.py).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import bitparse as bp
from portbench.reference import model

TPU_MAGIC = b"CCTP\x01"
PRECISION = 24
SYM_MIN, SYM_MAX = -64, 63
LEAK_STEP = 16
FREE_WEIGHT = (1 << PRECISION) - 1 - (SYM_MAX - SYM_MIN) * LEAK_STEP
EXP2_POLY = (16777216, -11629077, 4030290, -930970, 160710, -21395, 1835)
CSL, SL0 = 94548, 14032236
N_MU, N_SCALE = 32768, 2561
MU_MIN_FP, LOG_SCALE_MIN_FP = -64 * 256, -5 * 256
MASK, PAD = model.MASK, model.PAD
QUANTILE_MAX = (1 << PRECISION) - 1
U64 = np.uint64


def ctx_offsets(n_spatial: int) -> list[tuple[int, int]]:
    """(dy, dx) of the first n causal context pixels, in ARM input order."""
    return [(int(i) // MASK - PAD, int(i) % MASK - PAD) for i in model.ctx_index(n_spatial)]


def exp2_neg24(t: np.ndarray) -> np.ndarray:
    """2^24 * 2^(-t / 2^24) by the profile's integer Horner polynomial."""
    t = t.astype(U64)
    q = np.minimum(t >> U64(PRECISION), U64(40))
    f = (t & U64((1 << PRECISION) - 1)).astype(np.int64)
    r = np.full(t.shape, EXP2_POLY[6], dtype=np.int64)
    for k in range(5, -1, -1):
        r = EXP2_POLY[k] + ((r * f) >> PRECISION)
    return np.clip(r, 0, 1 << PRECISION).astype(U64) >> q


SLOPE = np.maximum((U64(SL0) * exp2_neg24(np.arange(N_SCALE, dtype=U64) * U64(CSL)))
                   >> U64(PRECISION), U64(1)).astype(np.int64)


def left_cum(s: np.ndarray, mu_fp: np.ndarray, slope: np.ndarray) -> np.ndarray:
    m = s * 256 - 128 - mu_fp
    half = (exp2_neg24(np.abs(m) * slope) >> U64(1)).astype(np.int64)
    cdf = np.where(m < 0, half, (1 << PRECISION) - half)
    out = ((FREE_WEIGHT * cdf) >> PRECISION) + (s - SYM_MIN) * LEAK_STEP
    return np.where(s <= SYM_MIN, 0, out)


def invert(q: np.ndarray, mu_fp: np.ndarray, slope: np.ndarray):
    """The symbol s with left_cum(s) <= q < left_cum(s + 1) (the top
    symbol's right end is 2^24), and both ends. The float64 inverse of the
    CDF, the leak left out, gives a first guess; the exact integer ends
    then move it one symbol at a time until it holds."""
    c = np.clip(q * (2.0 ** PRECISION / FREE_WEIGHT), 1.0, 2.0 ** PRECISION - 1.0)
    tail = np.where(c < 2.0 ** (PRECISION - 1), c, 2.0 ** PRECISION - c)
    am = np.log2(2.0 ** (PRECISION - 1) / tail) * 2.0 ** PRECISION / slope
    m = np.where(c < 2.0 ** (PRECISION - 1), -am, am)
    s = np.clip(np.floor((m + 128.0 + mu_fp) / 256.0), SYM_MIN, SYM_MAX).astype(np.int64)
    while True:
        left = left_cum(s, mu_fp, slope)
        right = np.where(s >= SYM_MAX, 1 << PRECISION,
                         left_cum(np.minimum(s + 1, SYM_MAX), mu_fp, slope))
        down, up = left > q, (right <= q) & (s < SYM_MAX)
        if not (down.any() or up.any()):
            return s, left, right
        s = s - down + up


class Streams:
    """The range decoders of one grid of G images, S streams each."""

    def __init__(self, words: list[list[np.ndarray]]):
        G, S = len(words), len(words[0])
        n = max(len(ws) for img in words for ws in img) + 2
        self.words = np.zeros((G, S, n), dtype=U64)
        for g, img in enumerate(words):
            for s, ws in enumerate(img):
                self.words[g, s, :len(ws)] = ws
        self.pos = np.full((G, S), 2, dtype=np.int64)
        self.lower = np.zeros((G, S), dtype=U64)
        self.range = np.full((G, S), np.iinfo(U64).max, dtype=U64)
        self.point = (self.words[:, :, 0] << U64(32)) | self.words[:, :, 1]
        self.gi = np.arange(G)[:, None]

    def decode(self, st: np.ndarray, mu_fp: np.ndarray, slope: np.ndarray) -> np.ndarray:
        """One symbol from each stream st[k] of every image ([G, K] model
        inputs, distinct streams) -> [G, K] symbols."""
        gi = self.gi
        lower, rng, point = self.lower[gi, st], self.range[gi, st], self.point[gi, st]
        scale = rng >> U64(PRECISION)
        with np.errstate(over="ignore"):
            q = np.minimum((point - lower) // scale, U64(QUANTILE_MAX)).astype(np.int64)
        lo, left, right = invert(q, mu_fp, slope)
        with np.errstate(over="ignore"):
            lower = lower + scale * left.astype(U64)
            rng = scale * (right - left).astype(U64)
            renorm = rng < U64(1 << 32)
            pos = self.pos[gi, st]
            nxt = self.words[gi, st, np.minimum(pos, self.words.shape[2] - 1)]
            lower = np.where(renorm, lower << U64(32), lower)
            rng = np.where(renorm, rng << U64(32), rng)
            point = np.where(renorm, (point << U64(32)) | nxt, point)
        self.lower[gi, st], self.range[gi, st], self.point[gi, st] = lower, rng, point
        self.pos[gi, st] = pos + renorm
        return lo


def arm_fixed(x: np.ndarray, fp: dict, n_raw_tail: int, out_shift: int = 8) -> np.ndarray:
    """X.8 int64 ARM: [G, B, dim] raw contexts (the last n_raw_tail columns
    already X.8, the others shifted up) -> [G, B, n_out]. fp's leaves carry
    a leading image axis."""
    def mm(a, w):
        # float64 products and sums are exact: the profile certifies every
        # intermediate under 2^31, far inside float64's 2^53
        return np.matmul(a.astype(np.float64), w).astype(np.int64)

    dim = x.shape[-1]
    x = x.copy()
    x[..., :dim - n_raw_tail] <<= 8
    stab = fp["stab_b"][:, None] + mm(x, fp["stab_w"])
    n = len(fp["w"])
    for layer in range(n - 1):
        y = fp["b"][layer][:, None] + mm(x, fp["w"][layer])
        x = np.maximum(y, 0) >> 8
    y = fp["b"][-1][:, None] + stab + mm(x, fp["w"][-1])
    return y >> out_shift


def _stack_fp(fps: list[dict]) -> dict:
    return {"w": [np.stack(ws).astype(np.float64)
                  for ws in zip(*(f["trunk_weights"] for f in fps))],
            "b": [np.stack(bs) for bs in zip(*(f["trunk_biases"] for f in fps))],
            "stab_w": np.stack([f["stab_weight"] for f in fps]).astype(np.float64),
            "stab_b": np.stack([f["stab_bias"] for f in fps])}


def _nearest_x2(x: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(x, 2, axis=-2), 2, axis=-1)


def ifce_context(fps: list[dict], decoded: list[np.ndarray], h: int, w: int,
                 n_out: int) -> np.ndarray:
    """[G, h * w, n_out] IFCE context of a grid from the coarser decoded
    grids ([G, h_j, w_j], largest first)."""
    rev = list(reversed(decoded))
    acc = rev[0][:, None]
    for target in rev[1:]:
        x = acc
        if acc.shape[-2:] != target.shape[-2:]:
            x = _nearest_x2(acc)[..., :target.shape[-2], :target.shape[-1]]
        acc = np.concatenate([target[:, None], x], axis=1)
    G, c, hc, wc = acc.shape
    flat = acc.reshape(G, c, hc * wc).transpose(0, 2, 1)
    ctx = arm_fixed(flat, _stack_fp(fps), n_raw_tail=0)
    ctx = ctx.transpose(0, 2, 1).reshape(G, n_out, hc, wc)
    ctx = _nearest_x2(ctx)[..., :h, :w]
    return ctx.reshape(G, n_out, h * w).transpose(0, 2, 1)


def wavefronts(h: int, w: int):
    """Pixels (ys, xs) of each wavefront of the profile's coding order."""
    if w <= MASK:
        for r in range(h):
            for c in range(w):
                yield np.array([r]), np.array([c])
        return
    step = max(5, -(-w // 128))
    for d in range(w - 1 + (h - 1) * step + 1):
        y_lo = (d - w) // step + 1 if d >= w else 0
        y_hi = min(d // step, h - 1)
        ys = np.arange(y_lo, y_hi + 1)
        yield ys, d - step * ys


def decode_grid(words, h: int, w: int, n_spatial: int, arm: dict,
                ifce: np.ndarray | None) -> np.ndarray:
    """Range-decode one [h, w] grid of G images: words[g][s] the u32
    words of stream s, arm the stacked X.8 main ARM, ifce [G, h*w, C_f]."""
    G = len(words)
    S = len(words[0])
    dec = Streams(words)
    wp = w + 2 * PAD
    buf = np.zeros((G, (h + 2 * PAD) * wp), dtype=np.int64)
    offs = np.array([dy * wp + dx for dy, dx in ctx_offsets(n_spatial)])
    n_ifce = 0 if ifce is None else ifce.shape[-1]
    for ys, xs in wavefronts(h, w):
        at = (ys + PAD) * wp + xs + PAD
        ctx = buf[:, at[:, None] + offs]                  # [G, K, n_spatial]
        if n_ifce:
            ctx = np.concatenate([ctx, ifce[:, ys * w + xs]], axis=-1)
        out = arm_fixed(ctx, arm, n_raw_tail=n_ifce)
        mu_fp = np.clip(out[..., 0] - MU_MIN_FP, 0, N_MU - 1) + MU_MIN_FP
        slope = SLOPE[np.clip(out[..., 1] - LOG_SCALE_MIN_FP, 0, N_SCALE - 1)]
        for a in range(0, len(ys), S):     # one symbol per stream at a time
            sl = slice(a, a + S)
            buf[:, at[sl]] = dec.decode(ys[sl] % S, mu_fp[:, sl], slope[:, sl])
    return buf.reshape(G, h + 2 * PAD, wp)[:, PAD:PAD + h, PAD:PAD + w].copy()


def parse(data: bytes) -> dict:
    """One single-frame intra `tpu` file -> headers, network, level blocks."""
    if not data.startswith(TPU_MAGIC):
        raise ValueError("not a tpu-profile file")
    rest = data[len(TPU_MAGIC):]
    _, rest = bp.VideoHeader.read(rest)
    fh, rest = bp.FrameHeader.read(rest)
    ch, rest = bp.CoolChicHeader.read(rest)
    cfg = ch.to_config()
    nn = bp.decode_network(rest[:ch.nn_n_bytes], cfg, ch.nn_q_step_shift,
                           ch.nn_expgol_cnt, ch.nn_n_bit_pad)
    lat = rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent]
    blocks, cur = {}, 0
    for level in range(cfg.n_latent_grids - 1, -1, -1):
        n = lat[cur]
        counts = np.frombuffer(lat, dtype="<u4", offset=cur + 1, count=n)
        cur += 1 + 4 * n
        ws = []
        for c in counts:
            ws.append(np.frombuffer(lat, dtype="<u4", offset=cur, count=int(c)).astype(U64))
            cur += 4 * int(c)
        blocks[level] = ws
    return {"frame": fh, "header": ch, "cfg": cfg, "nn": nn, "blocks": blocks}


def decode_latents(files: list[dict]) -> list[list[np.ndarray]]:
    """Every latent grid of a batch of parsed same-architecture files:
    [image][level] int64 [h, w]."""
    cfg = files[0]["cfg"]
    G = len(files)
    arm = _stack_fp([bp.arm8_from_int_layers(
        f["nn"]["arm"]["layers"], f["header"].nn_q_step_shift[("arm", "weight")],
        f["header"].nn_q_step_shift[("arm", "bias")],
        stabiliser=f["nn"]["arm"].get("stabiliser"), subtract_last_layer=True)
        for f in files])
    arm_index, k = {}, 0
    for i, n_in in enumerate(cfg.input_features_ifce):
        if n_in:
            arm_index[i], k = k, k + 1
    n_ifce = cfg.output_feature_ifce if cfg.flag_ifce else 0
    decoded: list[np.ndarray] = []      # largest first, [G, h, w]
    for level in range(cfg.n_latent_grids - 1, -1, -1):
        h, w = cfg.size_per_latent[level]
        ifce = None
        if n_ifce:
            if cfg.input_features_ifce[level] == 0:
                ifce = np.zeros((G, h * w, n_ifce), dtype=np.int64)
            else:
                fps = [bp.arm8_from_int_layers(
                    f["nn"]["ifce"]["arms"][arm_index[level]]["layers"],
                    f["header"].nn_q_step_shift[("ifce", "weight")],
                    f["header"].nn_q_step_shift[("ifce", "bias")], stabiliser=None,
                    subtract_last_layer=False, no_residual_layer=True) for f in files]
                ifce = ifce_context(fps, decoded, h, w, n_ifce)
        grid = decode_grid([f["blocks"][level] for f in files], h, w,
                           cfg.spatial_context_arm, arm, ifce)
        decoded.insert(0, grid)
    return [[g[i] for g in decoded] for i in range(G)]


def float_tail(f: dict, grids: list[np.ndarray], device) -> np.ndarray:
    """Decoded grids of one image -> raw synthesis output [1, C, H, W]."""
    cfg, nn = f["cfg"], f["nn"]
    if cfg.flag_common_randomness or cfg.final_upsampling_type != "bicubic":
        raise ValueError("the reference covers the intra configurations only")

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    syn_grids = [t(g) for g, hyper in zip(grids, cfg.flag_is_hyperlatent) if not hyper]
    ups = nn["upsampling"]
    syn = {k: [{n: t(v) for n, v in lay.items()} for lay in nn["synthesis"][k]]
           if k == "layers" else {n: t(v) for n, v in nn["synthesis"][k].items()}
           for k in nn["synthesis"]}
    with torch.no_grad():
        dense = model.upsample(syn_grids, [t(h) for h in ups["tconv_half"]],
                               [t(h) for h in ups["conv_half"]], cfg.ups_k_size,
                               cfg.ups_preconcat_k_size)
        out = model.synthesize(dense, syn, cfg.parsed_synthesis)
    if tuple(out.shape[-2:]) != tuple(cfg.img_size):
        raise ValueError("level 0 differs from the image size")
    return out[None].cpu().numpy()


def finish(raw: np.ndarray, bitdepth: int) -> np.ndarray:
    """Bitdepth rounding of an RGB frame, as the format's decoder ends."""
    m = 2 ** bitdepth - 1
    x = np.round(m * raw) / m
    return np.round(np.clip(x, 0.0, 1.0) * m) / m


def decode_files(datas: list[bytes], device="cpu", tf32: bool = False) -> list[np.ndarray]:
    """Decoded [1, 3, H, W] frames of same-architecture single-frame intra
    `tpu` files. tf32=True computes the float tail with TF32 (the
    benchmark's control)."""
    files = [parse(d) for d in datas]
    grids = decode_latents(files)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return [finish(float_tail(f, g, device), f["frame"].bitdepth)
                for f, g in zip(files, grids)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
