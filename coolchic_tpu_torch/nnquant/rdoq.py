"""RDOQ: greedy rate-distortion refinement of the quantized NN parameters.

ARM and IFCE are scored by pure rate (latent rate + module NN rate:
distortion does not move under entropy-model edits), synthesis by
distortion after bitdepth rounding + NN rate (RGB and YUV420), upsampling
and the synthesis rescale case (size_per_latent[0] != img_size) by a full
reconstruction per candidate (reference coolchic/nnquant/rdoq.py:28-462).

P/B frames (the reference's full-test() fallback, rdoq.py:131-137) score
the frame's reconstruction with the other cool-chic's contribution held
fixed (frame_ctx): the residue's synthesis row tiles and upsampling lanes
blend fixed warped references; every motion lane re-derives the flow and
re-warps the globally shifted references (the motion cool-chic always
takes the full-resolution lanes: its latents start below the image size).

Orchestration (the JAX package's, coolchic_tpu/nnquant/rdoq.py): scalars
are processed in chunks in an order drawn from np.random.default_rng(seed);
every (scalar, candidate shift) pair of a chunk is one lane of ONE batched
probe: the lanes are the batch axis G = S * C of the port's batched
forward, built as one [S * C, n] edited copy of the module's flat vector.
Per-scalar argmins are applied jointly; the next chunk's free zero-shift
column verifies the joint step, and a regression rolls back to the
previous chunk's single best edit; a final probe verifies the last chunk.
The chunk loop runs on the host: one host sync per probe (a few tens of
microseconds against a probe's milliseconds), counted in the sweep log.

JAX runs ARM / IFCE as one device program (f32 comparisons, no epsilon)
and synthesis / upsampling as a host loop (f64 comparisons, a 1e-9
epsilon on the rollback checks); `_sweep` is that one algorithm with the
epsilon as an argument. The values that decide which edits are accepted
are JAX's: the scalars per probe, the shift ladders, the rng order.
Memory-only knobs (latent slabs of the rate scorers, row tiles of the
synthesis scorer, lane groups of the full scorer, with a motion lane's
warp tensors counted) are sized from the device's free memory instead of a
v5e's: they change nothing but f32 summation order.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.nncodec import flatten_module_params, unflatten_module_params
from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.laplace import rate_bits
from coolchic_tpu_torch.models.arm import arm_apply, arm_reparameterize
from coolchic_tpu_torch.models.coolchic import ifce_context, make_cr_grids, synthesis_input
from coolchic_tpu_torch.models.frame import _to_420
from coolchic_tpu_torch.models.synthesis import synthesis_apply
from coolchic_tpu_torch.models.upsampling import fixed_upsampling, upsampling_apply
from coolchic_tpu_torch.models.warp import warp_fn
from coolchic_tpu_torch.nnquant.quantize import best_expgol
from coolchic_tpu_torch.ops.context import spatial_context
from coolchic_tpu_torch.ops.convs import replicate_pad
from coolchic_tpu_torch.ops.resize import interpolate

N_SHIFTS = 15
# ARM/IFCE probes are cheap (rate only) on small images: sweep every shift.
ARM_SHIFTS = tuple(range(-N_SHIFTS, N_SHIFTS + 1))
# Synthesis probes run a conv stack per candidate; the reference's early
# stop almost never walks past +-3, so probe a sparse ladder beyond it.
SYN_SHIFTS = (-15, -7, -3, -2, -1, 0, 1, 2, 3, 7, 15)
# Above _BIG_N_LAT latents the ARM/IFCE probes take the sparse ladder too,
# and every chunk shrinks (the JAX package's rule, which decides edits).
ARM_SHIFTS_BIG = SYN_SHIFTS
_BIG_N_LAT = 200_000
# |round(v / q)| above this is not codable: such candidates score +inf.
_MAX_Q = 65535
# Live activation tensors of one probe, in units of its widest tensor
# (inputs, a layer's output, ReLU / residual temporaries, rate terms).
_LIVE = 8
# Bytes per pixel and filter tap of one lane's warp (models/warp.py): the
# int64 tap indices and gather index, the f32 coefficients, one y-tap's
# [3, k] neighbours and their product.
_WARP_BYTES_PER_TAP_PX = 64


def _arm_shifts(n_lat: int) -> tuple:
    return ARM_SHIFTS if n_lat <= _BIG_N_LAT else ARM_SHIFTS_BIG


def _probe_budget_bytes(device: torch.device) -> int:
    """Activation bytes one probe may hold: a quarter of the card's memory
    (so a probe of a few hundred lanes runs in a few slabs or tiles on an
    80 GB card, where the JAX package sized them for a 16 GiB v5e), 1 GiB
    on the CPU. The card's total, not what is free at the moment: the
    slabs and tiles set the order of the sums, so an encode repeats only
    if they do."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 4
    return 2**30


def _expgol_bits(v: torch.Tensor, count: int) -> torch.Tensor:
    """Exp-Golomb code length of each integer-valued entry (f32). log2 is
    taken as XLA lowers jnp.log2, log(y) / log(2) in f32: at an exact power
    of two it lands one ulp below the integer, and the floor then gives the
    JAX package's length (2 bits under the exact one, for |v| = 2^k - 1
    with count 1, and the like)."""
    x = torch.abs(v)
    y = 2.0 * x / (2.0**count) + 1.0
    log2 = torch.log(y) / torch.log(torch.tensor(2.0, dtype=y.dtype, device=y.device))
    return 2.0 * torch.floor(log2) + count + (v != 0).to(v.dtype)


def _expgol_rate_bits(v: torch.Tensor, count: int) -> torch.Tensor:
    """Total exp-Golomb bits of v's last axis (exact: a sum of integers)."""
    return _expgol_bits(v, count).sum(dim=-1)


def _module_shapes(cc_params: dict, cfg: CoolChicConfig, module: str, wb: str):
    return [np.asarray(a).shape for a in flatten_module_params(cc_params, cfg, module, wb)]


def _flat(cc_params: dict, cfg: CoolChicConfig, module: str, wb: str) -> np.ndarray:
    arrays = flatten_module_params(cc_params, cfg, module, wb)
    if not arrays:
        return np.zeros((0,), np.float32)
    return np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in arrays])


def _rebuild(flat, shapes: list) -> list:
    """[..., n] flat -> the list of [..., *shape] pieces, in order."""
    arrays, ptr = [], 0
    lead = tuple(flat.shape[:-1])
    for s in shapes:
        n = int(np.prod(s))
        arrays.append(flat[..., ptr:ptr + n].reshape(lead + tuple(s)))
        ptr += n
    return arrays


def _set_flat(cc_params: dict, cfg: CoolChicConfig, module: str, wb: str,
              flat: np.ndarray) -> dict:
    out = copy.deepcopy(cc_params)
    unflatten_module_params(_rebuild(np.asarray(flat, np.float32),
                                     _module_shapes(cc_params, cfg, module, wb)),
                            cfg, module, wb, out)
    return out


# The builders take [G, n] flats (one lane a row) and return the batched
# parameter dicts of models/*.py (every leaf [G, ...]).
def _arm_from_flat(flat_w, flat_b, cfg: CoolChicConfig, shapes_w, shapes_b) -> dict:
    ws = _rebuild(flat_w, shapes_w)
    bs = _rebuild(flat_b, shapes_b)
    n_trunk = cfg.n_hidden_layers_arm + 1
    params = {"layers": [{"weight": w, "bias": b}
                         for w, b in zip(ws[:n_trunk], bs[:n_trunk])]}
    if cfg.linear_stabiliser_arm:
        params["stabiliser"] = {"weight": ws[n_trunk], "bias": bs[n_trunk]}
    return params


def _ifce_from_flat(flat_w, flat_b, shapes_w, shapes_b) -> dict:
    ws = _rebuild(flat_w, shapes_w)
    bs = _rebuild(flat_b, shapes_b)
    return {"arms": [{"layers": [{"weight": w, "bias": b}]} for w, b in zip(ws, bs)]}


def _ups_from_flat(flat_w, flat_b, shapes_w, shapes_b) -> dict:
    ws = _rebuild(flat_w, shapes_w)
    bs = _rebuild(flat_b, shapes_b)
    n_ups = len(ws) // 2
    return {"tconv_half": ws[:n_ups], "conv_half": ws[n_ups:],
            "tconv_bias": bs[:n_ups], "conv_bias": bs[n_ups:]}


def _syn_from_flat(flat_w, flat_b, cfg: CoolChicConfig, shapes_w, shapes_b) -> dict:
    ws = _rebuild(flat_w, shapes_w)
    bs = _rebuild(flat_b, shapes_b)
    params = {"output_transform": {"weight": ws[0], "bias": bs[0]}}
    i = 1
    if cfg.linear_stabiliser_synth:
        params["stabiliser"] = {"weight": ws[1], "bias": bs[1]}
        i = 2
    params["layers"] = [{"weight": w, "bias": b} for w, b in zip(ws[i:], bs[i:])]
    return params


def _lanes(flat_w: torch.Tensor, flat_b: torch.Tensor, wb: str, idxs: torch.Tensor,
           vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The S * C trial modules of a probe as [G, n] flats: lane s * C + c
    is flat_<wb> with scalar idxs[s] set to vals[s, c]; the other flat is
    broadcast. Returns (flat_w, flat_b, edited)."""
    S, C = vals.shape
    G = S * C
    edited = (flat_w if wb == "weight" else flat_b).expand(G, -1).clone()
    edited[torch.arange(G, device=edited.device), idxs.repeat_interleave(C)] = \
        vals.reshape(-1)
    if wb == "weight":
        return edited, flat_b.expand(G, -1), edited
    return flat_w.expand(G, -1), edited, edited


def _nn_bits(edited: torch.Tensor, q: float, cnt: int) -> torch.Tensor:
    return _expgol_rate_bits(torch.round(edited / q), cnt)


# ---------------------------------------------------------------------------
# Scorers: score(flat_w, flat_b, idxs [S], vals [S, C]) -> [S, C] losses,
# their fixed activations bound at construction.
# ---------------------------------------------------------------------------
def _make_rate_scorer(cfg: CoolChicConfig, module: str, wb: str, q: float, cnt: int,
                      shapes_w, shapes_b, lat: torch.Tensor, ctx: torch.Tensor,
                      budget_bytes: int, arm_flat_w: Optional[torch.Tensor] = None,
                      arm_flat_b: Optional[torch.Tensor] = None, arm_shapes_w=None,
                      arm_shapes_b=None, latents: Optional[list] = None):
    """ARM / IFCE scorer: latent rate in bits (through the main ARM) +
    module NN bits. lat: [N] rounded latents, all grids in order; ctx:
    [N, d] their ARM contexts (ARM: spatial + IFCE; IFCE: spatial only, the
    IFCE part is recomputed per lane from `latents`, the [h, w] grids).
    Latents run in slabs sized so that _LIVE [G, slab, d] tensors fit the
    budget."""
    n_lat = lat.shape[0]
    dim = cfg.total_context_arm

    def score(flat_w, flat_b, idxs, vals):
        S, C = vals.shape
        G = S * C
        fw, fb, edited = _lanes(flat_w, flat_b, wb, idxs, vals)
        if module == "arm":
            arm = _arm_from_flat(fw, fb, cfg, shapes_w, shapes_b)

            def ctx_of(a, b):
                return ctx[None, a:b].expand(G, -1, -1)
        else:   # ifce: edits change the context itself
            trial = {"ifce": _ifce_from_flat(fw, fb, shapes_w, shapes_b)}
            ctx_if = ifce_context(trial, cfg, [g[None].expand(G, -1, -1) for g in latents])
            arm = _arm_from_flat(arm_flat_w[None].expand(G, -1),
                                 arm_flat_b[None].expand(G, -1), cfg, arm_shapes_w,
                                 arm_shapes_b)

            def ctx_of(a, b):
                return torch.cat([ctx[None, a:b].expand(G, -1, -1), ctx_if[:, a:b]], dim=2)

        slab = max(1, budget_bytes // (_LIVE * 4 * G * dim))
        total = lat.new_zeros(G)
        for a in range(0, n_lat, slab):
            b = min(a + slab, n_lat)
            mu, scale = arm_reparameterize(arm_apply(arm, ctx_of(a, b)))
            total = total + rate_bits(lat[None, a:b], mu, scale).sum(dim=1)
        return (total + _nn_bits(edited, q, cnt)).reshape(S, C)

    return score


def _tiles(h: int, n_tiles: int, frame_data_type: str):
    """Row tiles of the synthesis scorer (coolchic_tpu/nnquant/rdoq.py:
    _make_syn_scorer): (rows_per, starts, row weights [T, rows_per]). Tiles
    can overlap at the bottom edge; the weights count each row once."""
    rows_per = -(-h // n_tiles)
    if frame_data_type == "yuv420":
        rows_per += rows_per % 2  # keep 420 2x2 blocks intact
    starts = [min(i * rows_per, max(h - rows_per, 0)) for i in range(n_tiles)]
    row_seen = np.zeros(h, np.int64)
    row_w = []
    for s in starts:
        r = np.arange(s, s + rows_per)
        row_w.append((row_seen[r] == 0).astype(np.float32))
        row_seen[r] += 1
    return rows_per, starts, np.stack(row_w)


def _syn_tile_count(cfg: CoolChicConfig, lanes: int, budget_bytes: int) -> int:
    """Fewest row tiles whose per-tile activations (lanes x the widest
    synthesis layer x (rows + halo) x W, _LIVE of them) fit the budget.
    Exact at any count: the receptive-field halo and the row weights make
    the tiles cover each output row once."""
    h, w = cfg.img_size
    halo = sum((k - 1) // 2 for _, k, _, _ in cfg.parsed_synthesis)
    width = max([cfg.input_feature_synthesis] + [o for o, _, _, _ in cfg.parsed_synthesis])
    per_row = _LIVE * 4 * lanes * width * w
    for n_tiles in range(1, h + 1):
        if per_row * (-(-h // n_tiles) + 2 * halo) <= budget_bytes:
            return n_tiles
    return h


def _blend(raw: torch.Tensor, frame_type: str, preds: list) -> torch.Tensor:
    """The decoded frame of a P/B residue output (models/frame.py):
    alpha * pred + residue, pred = warp 1 (P) or the beta blend of both
    (B); raw itself for an I frame."""
    if frame_type == "I":
        return raw
    alpha = torch.clamp(raw[:, 3:4] + 0.5, 0.0, 1.0)
    if frame_type == "P":
        pred = preds[0]
    else:
        beta = torch.clamp(raw[:, 4:5] + 0.5, 0.0, 1.0)
        pred = beta * preds[0] + (1.0 - beta) * preds[1]
    return alpha * pred + raw[:, :3]


def _make_syn_scorer(cfg: CoolChicConfig, wb: str, lmbda: float, q: float, cnt: int,
                     shapes_w, shapes_b, frame_data_type: str, bitdepth: int,
                     n_tiles: int, syn_in: torch.Tensor, target: torch.Tensor,
                     frame_type: str = "I", warps: tuple = ()):
    """Synthesis scorer of the residue cool-chic: distortion after bitdepth
    rounding (and 444->420 conversion for YUV) + lmbda * NN rate / n_pixels.
    The conv stack runs tile by tile over image rows with a receptive-field
    halo of edge-replicated rows, as the JAX package's tile scorer does.
    syn_in: [1, C_in, H, W]; target: [1, 3, H, W] (444 for yuv420); warps:
    a P/B frame's fixed warped references [1, 3, H, W], sliced per tile."""
    h, w = cfg.img_size
    halo = sum((k - 1) // 2 for _, k, _, _ in cfg.parsed_synthesis)
    max_dyn = float(2 ** bitdepth - 1)
    n_pixels = h * w
    rows_per, starts, row_w_np = _tiles(h, n_tiles, frame_data_type)
    # decoded samples counted, an exact integer
    if frame_data_type == "yuv420":
        npx = float(row_w_np.sum() * w + row_w_np[:, 0::2].sum() * w)
    else:
        n_ch = cfg.synthesis_out_ft if frame_type == "I" else 3
        npx = float(row_w_np.sum() * n_ch * w)
    row_w = torch.as_tensor(row_w_np, device=syn_in.device)
    syn_pad = replicate_pad(syn_in, (0, 0, halo, halo))
    specs = cfg.parsed_synthesis

    def score(flat_w, flat_b, idxs, vals):
        S, C = vals.shape
        G = S * C
        fw, fb, edited = _lanes(flat_w, flat_b, wb, idxs, vals)
        syn = _syn_from_flat(fw, fb, cfg, shapes_w, shapes_b)
        sse = syn_in.new_zeros(G)
        for t, start in enumerate(starts):
            tile_in = syn_pad[:, :, start:start + rows_per + 2 * halo].expand(G, -1, -1, -1)
            out = _blend(synthesis_apply(syn, specs, tile_in)[:, :, halo:halo + rows_per],
                         frame_type, [wp[:, :, start:start + rows_per] for wp in warps])
            tgt = target[:, :, start:start + rows_per]
            w_t = row_w[t]
            if frame_data_type == "yuv420":
                dec = {k: torch.round(torch.clamp(v, 0.0, 1.0) * max_dyn) / max_dyn
                       for k, v in _to_420(out).items()}
                tgt420 = _to_420(tgt)
                wy = w_t[None, None, :, None]
                wu = w_t[0::2][None, None, :, None]
                sse = sse + sum((torch.square(dec[k] - tgt420[k]) * wk).reshape(G, -1).sum(1)
                                for k, wk in (("y", wy), ("u", wu), ("v", wu)))
            else:
                dec = out if frame_data_type == "flow" else torch.clamp(out, 0.0, 1.0)
                dec = torch.round(dec * max_dyn) / max_dyn
                sse = sse + (torch.square(dec - tgt) * w_t[None, None, :, None]
                             ).reshape(G, -1).sum(1)
        dist = sse / npx
        return (dist + lmbda * _nn_bits(edited, q, cnt) / n_pixels).reshape(S, C)

    return score


def _full_dist(dec_raw: torch.Tensor, target: torch.Tensor, frame_data_type: str,
               max_dyn: float) -> torch.Tensor:
    """Full-resolution distortion after bitdepth rounding of G images, [G],
    same weighting as the tile scorer (every decoded SAMPLE counts once;
    yuv420 therefore weights Y 4x vs each chroma by pixel count)."""
    G = dec_raw.shape[0]
    if frame_data_type == "yuv420":
        dec = {k: torch.round(torch.clamp(v, 0.0, 1.0) * max_dyn) / max_dyn
               for k, v in _to_420(dec_raw).items()}
        tgt = _to_420(target)
        sse = sum(torch.square(dec[k] - tgt[k]).reshape(G, -1).sum(1) for k in ("y", "u", "v"))
        npx = sum(dec[k][0].numel() for k in ("y", "u", "v"))
        return sse / npx
    dec = dec_raw if frame_data_type == "flow" else torch.clamp(dec_raw, 0.0, 1.0)
    dec = torch.round(dec * max_dyn) / max_dyn
    return torch.square(dec - target).reshape(G, -1).mean(1)


def _make_full_scorer(cfg: CoolChicConfig, module: str, wb: str, lmbda: float, q: float,
                      cnt: int, shapes_w, shapes_b, frame_data_type: str, bitdepth: int,
                      target: torch.Tensor, budget_bytes: int,
                      syn_in: Optional[torch.Tensor] = None,
                      syn_flat_w: Optional[torch.Tensor] = None,
                      syn_flat_b: Optional[torch.Tensor] = None,
                      syn_shapes_w=None, syn_shapes_b=None,
                      grids: Optional[list] = None,
                      cr_extra: Optional[torch.Tensor] = None,
                      frame_type: str = "I", role: str = "residue", aux: tuple = (),
                      warp_filter_size: int = 8):
    """Full-resolution reconstruction scorer: the UPSAMPLING module (edits
    move the dense stack, which is global, so row tiles do not apply), the
    synthesis rescale case (the synthesis output is interpolated to the
    image size), and every module of the MOTION cool-chic (edits move the
    flow, hence the warped prediction). Latent rate is constant under these
    edits: score = distortion(decoded) + lmbda * module NN bits / n_pixels.

    module "synthesis": syn_in [1, C, h0, w0] is the fixed input.
    module "upsampling": the fixed synthesis (syn_flat_w / _b), the [h, w]
    synthesis grids, and cr_extra [1, C_cr, H, W] with common randomness.
    aux, for P/B frames: role "residue", the fixed warped reference(s);
    role "motion", (the residue cool-chic's fixed raw output, *the globally
    shifted references), re-warped in each lane by its flow(s).
    Lanes run in groups whose reconstructions (and warps) fit the budget."""
    h, w = cfg.img_size
    n_pixels = h * w
    max_dyn = float(2 ** bitdepth - 1)
    specs = cfg.parsed_synthesis
    width = max([cfg.input_feature_synthesis] + [o for o, _, _, _ in specs])
    lane_bytes = _LIVE * 4 * width * n_pixels
    if role == "motion":
        lane_bytes += _WARP_BYTES_PER_TAP_PX * warp_filter_size * n_pixels
    group = max(1, budget_bytes // lane_bytes)

    def decoded(raw):
        """The frame decoded from g lanes' raw outputs [g, C, H, W]."""
        if frame_type == "I" or role == "residue":
            return _blend(raw, frame_type, list(aux))
        g = raw.shape[0]
        other, refs = aux[0].expand(g, -1, -1, -1), aux[1:]
        preds = [warp_fn(r.expand(g, -1, -1, -1), raw[:, 2 * i:2 * i + 2], warp_filter_size,
                         training=False) for i, r in enumerate(refs)]
        return _blend(other, frame_type, preds)

    def recon(fw, fb):
        g = fw.shape[0]
        if module == "synthesis":
            syn = _syn_from_flat(fw, fb, cfg, shapes_w, shapes_b)
            x = syn_in.expand(g, -1, -1, -1)
        else:
            ups = _ups_from_flat(fw, fb, shapes_w, shapes_b)
            x = upsampling_apply(ups["tconv_half"], ups["conv_half"],
                                 [gr[None].expand(g, -1, -1) for gr in grids],
                                 cfg.ups_k_size, cfg.ups_preconcat_k_size)
            if cr_extra is not None:
                x = torch.cat([x, cr_extra.expand(g, -1, -1, -1)], dim=1)
            syn = _syn_from_flat(syn_flat_w[None].expand(g, -1), syn_flat_b[None].expand(g, -1),
                                 cfg, syn_shapes_w, syn_shapes_b)
        return interpolate(synthesis_apply(syn, specs, x), cfg.img_size,
                           cfg.final_upsampling_type)

    def score(flat_w, flat_b, idxs, vals):
        S, C = vals.shape
        fw, fb, edited = _lanes(flat_w, flat_b, wb, idxs, vals)
        dist = torch.cat([_full_dist(decoded(recon(fw[g0:g0 + group], fb[g0:g0 + group])),
                                     target, frame_data_type, max_dyn)
                          for g0 in range(0, S * C, group)])
        return (dist + lmbda * _nn_bits(edited, q, cnt) / n_pixels).reshape(S, C)

    return score


# ---------------------------------------------------------------------------
# Chunked parallel-greedy sweep.
# ---------------------------------------------------------------------------
def _sweep(scorer, flat_w: np.ndarray, flat_b: np.ndarray, wb: str, shifts: tuple,
           q: float, chunk: int, rng, eps: float, device: torch.device,
           stats: Optional[dict] = None) -> tuple[np.ndarray, np.ndarray]:
    """Greedy coordinate refinement of flat_<wb>: chunks of `chunk` scalars
    in rng order, every (scalar, shift) scored in one probe, per-scalar
    argmins applied jointly; a regression (the next chunk's zero-shift
    column above the last applied chunk's base by more than `eps`) rolls
    back to that chunk's single best edit, and one more probe verifies the
    last applied chunk. eps = 0 gives coolchic_tpu/nnquant/rdoq.py:
    _sweep_device's decisions, eps = 1e-9 _sweep_host's. `stats`, when
    given, gains the counts of probes, lanes, host syncs, scalars adjusted,
    rollbacks, and ties (scalars whose best loss two candidates share)."""
    flat = (flat_w if wb == "weight" else flat_b).copy()
    n = flat.size
    if n == 0:
        return flat_w, flat_b
    order = rng.permutation(n)
    shifts_np = np.asarray(shifts, np.float32) * np.float32(q)
    zero_col = int(np.argwhere(np.asarray(shifts) == 0)[0, 0])
    fixed = torch.as_tensor(flat_b if wb == "weight" else flat_w, device=device)
    stats = {} if stats is None else stats
    for k in ("probes", "lanes", "syncs", "adjusted", "rollbacks", "ties"):
        stats.setdefault(k, 0)

    def run(chunk_idx):
        f = torch.as_tensor(flat, device=device)
        vals = flat[chunk_idx][:, None] + shifts_np[None, :]
        losses = scorer(f if wb == "weight" else fixed, fixed if wb == "weight" else f,
                        torch.as_tensor(chunk_idx, device=device),
                        torch.as_tensor(vals, device=device))
        losses = losses.cpu().numpy().astype(np.float64)   # the probe's host sync
        stats["probes"] += 1
        stats["lanes"] += vals.size
        stats["syncs"] += 1
        losses[np.abs(np.round(vals / q)) > _MAX_Q] = np.inf
        return losses, vals

    def rollback(prev):
        stats["rollbacks"] += 1
        p_flat, p_idxs, p_vals, p_base, p_losses = prev
        r, c = np.unravel_index(np.argmin(p_losses), p_losses.shape)
        if p_losses[r, c] < p_base:
            p_flat[p_idxs[r]] = p_vals[r, c]
        return p_flat

    prev = None  # (flat_before, idxs, vals, base, losses) of the last applied chunk
    for c0 in range(0, n, chunk):
        idxs = order[c0:c0 + chunk]
        losses, vals = run(idxs)
        base = float(losses[0, zero_col])
        if prev is not None and base > prev[3] + eps:
            # joint apply regressed: roll back to the single best edit of
            # the previous chunk (its gain was measured exactly)
            flat = rollback(prev)
            losses, vals = run(idxs)
            base = float(losses[0, zero_col])

        best_c = np.argmin(losses, axis=1)
        row_best = losses[np.arange(len(idxs)), best_c]
        stats["ties"] += int(((losses == row_best[:, None]).sum(axis=1) > 1).sum())
        improve = (row_best < base) & (best_c != zero_col)
        if improve.any():
            prev = (flat.copy(), idxs, vals, base, losses)
            flat[idxs[improve]] = vals[np.arange(len(idxs))[improve], best_c[improve]]
            stats["adjusted"] += int(improve.sum())
        else:
            prev = None

    # verify the last applied chunk with one extra base probe
    if prev is not None:
        losses, _ = run(order[:1])
        if float(losses[0, zero_col]) > prev[3] + eps:
            flat = rollback(prev)

    if wb == "weight":
        return flat, flat_b
    return flat_w, flat


def _frame_aux(frame_ctx: Optional[dict], frame_type: str, device: torch.device) -> tuple:
    """The fixed P/B activations of frame_ctx on `device` (see
    rdoq_coolchic): the warps (role residue), or the other cool-chic's raw
    output then the shifted references (role motion); () for I frames."""
    if frame_type == "I":
        return ()
    keys = ("warps",) if frame_ctx.get("role", "residue") == "residue" \
        else ("other_raw", "refs")
    out = []
    for k in keys:
        v = frame_ctx[k]
        for a in (v if isinstance(v, (list, tuple)) else [v]):
            out.append(torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a)
                                       else a.float(), device=device))
    return tuple(out)


def module_scorers(params: dict, cfg: CoolChicConfig, module: str, q_shift: dict,
                   expgol: dict, lmbda: float, target, frame_data_type: str, bitdepth: int,
                   device: torch.device, budget_bytes: int, frame_type: str = "I",
                   frame_ctx: Optional[dict] = None) -> tuple[tuple, int, float, dict]:
    """One module's sweep setup for the current (numpy) params: (shifts,
    chunk, eps, {wb: scorer}) for the wb sweeps that run. The scorers'
    fixed activations depend only on the other modules, so the bias scorer
    stays valid after the weight sweep. frame_ctx: as rdoq_coolchic's."""
    latents = [torch.round(torch.tensor(np.asarray(lat, np.float32), device=device)
                           * cfg.encoder_gain) for lat in params["latents"]]
    n_lat = sum(g.numel() for g in latents)
    shapes = {wb: _module_shapes(params, cfg, module, wb) for wb in ("weight", "bias")}
    wbs = [wb for wb in ("weight", "bias") if _flat(params, cfg, module, wb).size
           # upsampling biases take no part in the forward (kept for
           # descriptor parity): an edit can only add NN rate, so the sweep
           # would always re-pick 0; skip the probes
           and not (module == "upsampling" and wb == "bias")]

    def on_dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def batched(tree):
        """One numpy sub-tree of the params as [1, ...] tensors."""
        if isinstance(tree, dict):
            return {k: batched(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [batched(v) for v in tree]
        return on_dev(tree)[None]

    def q_cnt(wb):
        return float(2.0 ** q_shift[(module, wb)]), int(expgol[(module, wb)])

    if module in ("arm", "ifce"):
        lat_flat = torch.cat([g.reshape(-1) for g in latents])
        ctx_sp = torch.cat([spatial_context(g, cfg.spatial_context_arm) for g in latents])
        shifts = _arm_shifts(n_lat)
        # ARM / IFCE decide as the JAX package's device sweep (f32, no epsilon)
        eps = 0.0
        if module == "arm":
            ctx = ctx_sp
            if cfg.flag_ifce:
                ctx_if = ifce_context({"ifce": batched(params["ifce"])}, cfg,
                                      [g[None] for g in latents])[0]
                ctx = torch.cat([ctx_sp, ctx_if], dim=1)
            chunk = 4 if n_lat > _BIG_N_LAT else 8
            scorers = {wb: _make_rate_scorer(cfg, module, wb, *q_cnt(wb), shapes["weight"],
                                             shapes["bias"], lat_flat, ctx, budget_bytes)
                       for wb in wbs}
        else:
            chunk = 1 if n_lat > _BIG_N_LAT else 2
            arm = [on_dev(_flat(params, cfg, "arm", wb)) for wb in ("weight", "bias")]
            arm_shapes = [_module_shapes(params, cfg, "arm", wb) for wb in ("weight", "bias")]
            scorers = {wb: _make_rate_scorer(cfg, module, wb, *q_cnt(wb), shapes["weight"],
                                             shapes["bias"], lat_flat, ctx_sp, budget_bytes,
                                             *arm, *arm_shapes, latents)
                       for wb in wbs}
        return shifts, chunk, eps, scorers

    syn_grids = [g for g, hyper in zip(latents, cfg.flag_is_hyperlatent) if not hyper]
    cr = make_cr_grids(cfg, device)
    rescale = cfg.size_per_latent[0] != cfg.img_size
    tgt = on_dev(target)
    role = (frame_ctx or {}).get("role", "residue")
    aux = _frame_aux(frame_ctx, frame_type, device)
    use_tiles = module == "synthesis" and role == "residue" and not rescale
    # full-resolution lanes hold a whole reconstruction each: small chunks
    # on big images (the JAX package's chunk sizes); synthesis / upsampling
    # decide as its host sweep (f64, a 1e-9 epsilon)
    if use_tiles:
        chunk = 8 if n_lat > _BIG_N_LAT else 16
    else:
        chunk = 2 if n_lat > _BIG_N_LAT else 8
    shifts, eps = SYN_SHIFTS, 1e-9
    kw = dict(frame_data_type=frame_data_type, bitdepth=bitdepth, frame_type=frame_type)
    full_kw = dict(role=role, aux=aux,
                   warp_filter_size=int((frame_ctx or {}).get("warp_filter_size", 8)))
    if module == "synthesis":
        ups = batched(params["upsampling"])
        dense = upsampling_apply(ups["tconv_half"], ups["conv_half"],
                                 [g[None] for g in syn_grids], cfg.ups_k_size,
                                 cfg.ups_preconcat_k_size)
        # rescale + CR cannot coexist (synthesis_input concatenates at
        # img_size); dense is the rescale case's input
        syn_in = dense if rescale else synthesis_input(cfg, dense, cr)
        if use_tiles:
            n_tiles = _syn_tile_count(cfg, chunk * len(shifts), budget_bytes)
            scorers = {wb: _make_syn_scorer(cfg, wb, float(lmbda), *q_cnt(wb),
                                            shapes["weight"], shapes["bias"], n_tiles=n_tiles,
                                            syn_in=syn_in, target=tgt, warps=aux, **kw)
                       for wb in wbs}
        else:
            scorers = {wb: _make_full_scorer(cfg, module, wb, float(lmbda), *q_cnt(wb),
                                             shapes["weight"], shapes["bias"], target=tgt,
                                             budget_bytes=budget_bytes, syn_in=syn_in,
                                             **full_kw, **kw)
                       for wb in wbs}
        return shifts, chunk, eps, scorers

    cr_extra = None
    if cr is not None:
        cr_extra = interpolate(fixed_upsampling(cr, mode="bicubic"), cfg.img_size,
                               "bicubic")[None]
    syn = dict(syn_flat_w=on_dev(_flat(params, cfg, "synthesis", "weight")),
               syn_flat_b=on_dev(_flat(params, cfg, "synthesis", "bias")),
               syn_shapes_w=_module_shapes(params, cfg, "synthesis", "weight"),
               syn_shapes_b=_module_shapes(params, cfg, "synthesis", "bias"))
    scorers = {wb: _make_full_scorer(cfg, module, wb, float(lmbda), *q_cnt(wb),
                                     shapes["weight"], shapes["bias"], target=tgt,
                                     budget_bytes=budget_bytes, grids=syn_grids,
                                     cr_extra=cr_extra, **syn, **full_kw, **kw)
               for wb in wbs}
    return shifts, chunk, eps, scorers


def rdoq_coolchic(cc_params: dict, cfg: CoolChicConfig, q_shift: dict, expgol: dict,
                  lmbda: float, target=None, frame_type: str = "I",
                  frame_data_type: str = "rgb", bitdepth: int = 8, seed: int = 0,
                  modules: tuple = None, frame_ctx: dict = None, verbose: bool = False,
                  device: torch.device | str = "cuda",
                  log: Optional[list] = None) -> dict:
    """Refine the quantized NN params of one cool-chic decoder (numpy
    params in, numpy params out) on `device`.

    target: dense [1, C, H, W] array (RGB, or the 444 representation of
    yuv420 content: the scorers convert to 420 and weight channels by pixel
    count, as the reference's score_syn_image does).

    frame_ctx: the fixed frame-level activations that let synthesis and
    upsampling be scored on P/B frames (arrays or tensors). Keys:
      role: "residue" (default) or "motion" -- which cool-chic this is;
      warps: for role residue, the warped (and globally shifted)
        reference(s) [1, 3, H, W] under the current motion, 1 for P, 2 for B;
      other_raw: for role motion, the residue cool-chic's fixed raw output
        [1, 4|5, H, W] (residue, alpha (, beta));
      refs: for role motion, the globally shifted references [1, 3, H, W];
      warp_filter_size: for role motion, the frame's warp filter taps.
    With frame_ctx None on a P/B frame only ARM and IFCE are refined.

    `expgol` is updated in
    place by the post-RDOQ exp-Golomb re-search. `log`, when given, gains
    one record per (module, wb) sweep: seconds (the device synchronised),
    the scalar count, and _sweep's counts (probes, lanes, host syncs,
    scalars adjusted, rollbacks, ties)."""
    device = torch.device(device)
    role = (frame_ctx or {}).get("role", "residue")
    has_recon = target is not None and (
        frame_type == "I"
        or (frame_ctx is not None
            and (("warps" in frame_ctx) if role == "residue"
                 else ("refs" in frame_ctx and "other_raw" in frame_ctx))))
    if modules is None:
        # reference order: sorted(modules_to_send) = arm, ifce?, synthesis,
        # upsampling (reference nnquant/rdoq.py:68)
        modules = ("arm",) + (("ifce",) if cfg.flag_ifce else ()) + \
            (("synthesis", "upsampling") if has_recon else ())
    rng = np.random.default_rng(seed)
    params = cc_params
    budget = _probe_budget_bytes(device)

    for module in modules:
        if module in ("synthesis", "upsampling") and not has_recon:
            continue
        if module == "ifce" and not cfg.flag_ifce:
            continue
        flat_w = _flat(params, cfg, module, "weight")
        flat_b = _flat(params, cfg, module, "bias")
        if flat_w.size == 0 and flat_b.size == 0:
            continue
        shifts, chunk, eps, scorers = module_scorers(
            params, cfg, module, q_shift, expgol, lmbda, target, frame_data_type, bitdepth,
            device, budget, frame_type=frame_type, frame_ctx=frame_ctx)
        for wb, scorer in scorers.items():
            stats = {}
            t0 = time.time()
            flat_w, flat_b = _sweep(scorer, flat_w, flat_b, wb, shifts,
                                    float(2.0 ** q_shift[(module, wb)]), chunk, rng, eps,
                                    device, stats)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            n = (flat_w if wb == "weight" else flat_b).size
            rec = {"module": module, "wb": wb, "seconds": time.time() - t0, "n": n,
                   "chunk": chunk, "shifts": len(shifts), **stats}
            if log is not None:
                log.append(rec)
            if verbose:
                print(f"  rdoq {module}.{wb}: {stats['adjusted']}/{n} scalars adjusted "
                      f"({stats['probes']} probes, {rec['seconds']:.2f} s)", flush=True)

        params = _set_flat(params, cfg, module, "weight", flat_w)
        params = _set_flat(params, cfg, module, "bias", flat_b)

    # Post-RDOQ exp-Golomb re-search: the greedy edits change the integer
    # histogram, so the per-tensor order chosen before RDOQ can be stale;
    # re-picking it only lowers the written NN bytes (the JAX package's
    # addition to the reference).
    if expgol is not None:
        for module in modules:
            for wb in ("weight", "bias"):
                flat = _flat(params, cfg, module, wb)
                if flat.size == 0:
                    continue
                q = float(2.0 ** q_shift[(module, wb)])
                cnt_new, _ = best_expgol(np.round(flat / q))
                expgol[(module, wb)] = int(cnt_new)

    return params
