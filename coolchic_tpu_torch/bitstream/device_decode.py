"""Batched on-device decode of `tpu`-profile bitstreams.

For a group of same-architecture images:

  host:   parse headers, exp-Golomb NN decode, range-decode the grids
          neither kernel takes (raster-coded grids with w <= 9, the
          coarsest of a ladder), upload the stream words.
  device: every grid with fewer than 128 streams and no IFCE inputs, of
          every image, in one launch of the small-grid decode
          (ops/small_grid_decode.py); then for each remaining level
          (coarse -> fine): IFCE context (int32 fixed point, certified)
          from the already decoded coarser grids -> the small-grid decode
          (fewer than 128 streams), or a shear to the kernel layout -> CUDA
          wavefront range decode (128 streams, ops/wavefront_decode.py);
          then the float tail (learned upsampling + synthesis + rescale)
          over the image batch.

Which way a grid goes follows from its bitstream: its stream count and its
shape. Only the stream words go host->device and only the final images and
grids come back. Bit-exactness: both kernels compute the host C++
decoder's function, and the IFCE forward is int32 under an encoder-grade
overflow certificate checked on the host before routing (int32 wraparound
is exact whenever the true value fits), so the integer path equals the
host decoder's; tests/test_torch_device_decode.py pins it.

Reference parity: coolchic_tpu/bitstream/device_decode.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.codec import (
    _ifce_fixed_params,
    _main_arm_params,
    decode_tpu_level_host,
)
from coolchic_tpu_torch.bitstream.headers import CoolChicHeader
from coolchic_tpu_torch.bitstream.nncodec import decode_network
from coolchic_tpu_torch.bitstream.tpu_cdf import arm8_bounds_ok
from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.constants import non_zero_pixel_ctx_index
from coolchic_tpu_torch.core.device import resolve_device
from coolchic_tpu_torch.models.arm import ifce_arm_index
from coolchic_tpu_torch.models.params import params_from_jax
from coolchic_tpu_torch.models.synthesis import synthesis_batched
from coolchic_tpu_torch.models.upsampling import upsampling_batched
from coolchic_tpu_torch.ops import small_grid_decode as sgd
from coolchic_tpu_torch.ops import wavefront_decode as wfd
from coolchic_tpu_torch.ops.resize import interpolate
from coolchic_tpu_torch.utils import trace

LANES = 128


# ---------------------------------------------------------------------------
# Static shear index maps (host numpy, cached per grid shape).
# ---------------------------------------------------------------------------
@lru_cache(maxsize=64)
def _shear_maps(h: int, w: int) -> tuple[np.ndarray, int]:
    """(shear_src [D*128] int32 raster index per (wavefront, lane) with h*w
    as the idle-lane sentinel, D). The kernel writes its symbols straight
    into [G, h, w], so there is no de-shear map."""
    return wfd.shear_src(h, w), wfd.n_wavefronts(h, w)


@lru_cache(maxsize=64)
def _shear_maps_coarse(h: int, w: int, hc: int, wc: int) -> np.ndarray:
    """Shear map that fuses the nearest-x2 IFCE upsample: slot (d, lane) of
    the [h, w] grid reads coarse pixel (y//2, x//2) of the [hc, wc] context
    (sentinel hc*wc for idle slots): the host's _nearest_x2_int + crop."""
    assert h <= 2 * hc and w <= 2 * wc
    src, _ = _shear_maps(h, w)
    y, x = np.divmod(src.astype(np.int64), w)
    return np.where(src < h * w, (y // 2) * wc + (x // 2), hc * wc).astype(np.int32)


def _pack_int16_pairs(ctx: torch.Tensor) -> torch.Tensor:
    """[..., n_ifce] int32 (certified |v| < 2^15) -> [..., ceil(n/2)] int32
    with feature 2k in the low half-word and 2k+1 in the high half-word."""
    n = ctx.shape[-1]
    if n % 2:
        ctx = torch.cat([ctx, torch.zeros_like(ctx[..., :1])], dim=-1)
    return (ctx[..., 1::2] << 16) | (ctx[..., 0::2] & 0xFFFF)


def _shear_ifce(ctx: torch.Tensor, h: int, w: int, hc: int, wc: int,
                packed: bool) -> torch.Tensor:
    """Coarse context [G, hc*wc, n_ifce] int32 -> kernel layout
    [D, rows, G, 128] (rows = n_ifce, or ceil(n_ifce/2) int16-packed)."""
    src = torch.as_tensor(_shear_maps_coarse(h, w, hc, wc), dtype=torch.int64,
                          device=ctx.device)
    _, D = _shear_maps(h, w)
    if packed:
        ctx = _pack_int16_pairs(ctx)
    G, _, rows = ctx.shape
    padded = torch.cat([ctx, torch.zeros_like(ctx[:, :1])], dim=1)
    sheared = padded[:, src].reshape(G, D, LANES, rows)
    return sheared.permute(1, 3, 0, 2).contiguous()


# ---------------------------------------------------------------------------
# On-device int32 IFCE context (exact: certified against overflow on host).
# ---------------------------------------------------------------------------
def _ifce_ctx_device(decoded: list[torch.Tensor], cfg: CoolChicConfig,
                     ifce_w: torch.Tensor, ifce_b: torch.Tensor
                     ) -> tuple[torch.Tensor, int, int]:
    """IFCE context of a level at the coarse resolution of the next level
    (the nearest-x2 upsample to the grid's own resolution is fused into the
    shear gather). decoded = [level+1, level+2, ...] each [G, h, w] int32;
    ifce_w [G, c_in, n_out] X.8+q int32, ifce_b [G, n_out] X.16+q. Returns
    (ctx [G, h*w, n_ifce] int32 X.8, h, w); mirrors
    codec._ifce_context_for_grid (model 1)."""
    h, w = decoded[0].shape[-2:]
    acc = None
    for g in reversed(decoded):                    # coarsest first
        if acc is None:
            acc = g[:, None]
        else:
            if acc.shape[-2:] != g.shape[-2:]:
                acc = acc.repeat_interleave(2, -2).repeat_interleave(2, -1)[
                    :, :, : g.shape[-2], : g.shape[-1]]
            acc = torch.cat([g[:, None], acc], dim=1)
    G, c = acc.shape[:2]
    x = acc.reshape(G, c, h * w) << 8
    # single-layer X.8 ARM: y = ((x << 8) @ W + b) >> 8, int32 (certified)
    outs = []
    for o in range(cfg.output_feature_ifce):
        acc_o = ifce_b[:, o:o + 1]
        for i in range(c):
            acc_o = acc_o + ifce_w[:, i, o:o + 1] * x[:, i]
        outs.append(acc_o >> 8)
    return torch.stack(outs, dim=2), h, w


# ---------------------------------------------------------------------------
# Host-side orchestration.
# ---------------------------------------------------------------------------
def _parse_level_blocks(cfg: CoolChicConfig, lat: bytes) -> dict:
    """Split one latent payload into per-level stream blocks
    {level: {"n_streams", "words": [u32 arrays]}} (written coarse -> fine)."""
    blocks = {}
    cursor = 0
    for level in range(cfg.n_latent_grids - 1, -1, -1):
        n_streams = lat[cursor]
        cursor += 1
        counts = np.frombuffer(lat, dtype="<u4", offset=cursor, count=n_streams)
        cursor += 4 * n_streams
        words = []
        for cnt in counts:
            words.append(np.frombuffer(lat, dtype=np.uint32, offset=cursor,
                                       count=int(cnt)).copy())
            cursor += 4 * int(cnt)
        blocks[level] = {"n_streams": n_streams, "words": words}
    return blocks


def _group_key(cfg: CoolChicConfig):
    return (cfg.size_per_latent, cfg.spatial_context_arm, cfg.n_hidden_layers_arm,
            cfg.total_context_arm, cfg.linear_stabiliser_arm, cfg.flag_ifce,
            cfg.output_feature_ifce, cfg.input_features_ifce,
            cfg.ups_k_size, cfg.ups_preconcat_k_size, cfg.parsed_synthesis,
            cfg.img_size, cfg.final_upsampling_type, cfg.flag_is_hyperlatent,
            cfg.flag_common_randomness)


class DeviceBatch:
    """Prepared device decode of a group of same-architecture images:
    __init__ does the host work and the uploads, run() the device work."""

    def __init__(self, states: list[dict], device: torch.device):
        self.device = device
        st0 = states[0]
        cfg: CoolChicConfig = st0["cfg"]
        self.cfg = cfg
        G = len(states)
        self.G = G
        self.n_ifce = cfg.output_feature_ifce if cfg.flag_ifce else 0
        dim = cfg.spatial_context_arm + self.n_ifce

        # The route of each level, by what the bitstream says, decided here
        # before anything runs on the device: 128 streams and a shape the
        # wavefront kernel takes (device_levels); fewer streams and a shape
        # the small-grid kernel takes (small_levels); else the host.
        levels = range(cfg.n_latent_grids - 1, -1, -1)       # coarse -> fine
        n_streams = {}
        for level in levels:
            ns = {s["blocks"][level]["n_streams"] for s in states}
            if len(ns) != 1:
                raise ValueError(f"level {level} has different stream counts; host path")
            n_streams[level] = ns.pop()
        self.device_levels = tuple(
            level for level in levels if n_streams[level] == LANES
            and wfd.kernel_eligible(*cfg.size_per_latent[level], dim,
                                    cfg.n_hidden_layers_arm))
        self.small_levels = tuple(
            level for level in levels if n_streams[level] < LANES
            and sgd.kernel_eligible(*cfg.size_per_latent[level], n_streams[level], dim,
                                    cfg.n_hidden_layers_arm))
        self.host_levels = tuple(level for level in levels if level not in
                                 self.device_levels + self.small_levels)
        # Host levels decode before the device ones, so every host level
        # must be coarser than every device level (narrow grids are the
        # coarsest of a ladder).
        on_device = self.device_levels + self.small_levels
        if self.host_levels and on_device and min(self.host_levels) < max(on_device):
            raise ValueError("a host-route grid finer than a device grid; host path")

        with trace.span("decode.prepare.host_levels"):
            for s in states:  # host-decode the grids neither kernel takes
                s["decoded"] = {}
                for level in self.host_levels:
                    s["decoded"][level] = decode_tpu_level_host(
                        s["nn"], cfg, s["header"], s["arm"], level,
                        s["blocks"][level]["words"],
                        [s["decoded"][l] for l in range(level + 1, cfg.n_latent_grids)])

        def dev(a) -> torch.Tensor:
            return torch.as_tensor(a, device=device)

        with trace.span("decode.prepare.upload"):
            # stream words per device level: [R, G, 128] (u32 bits in int32)
            self.words = []
            for level in self.device_levels:
                R = wfd.words_bucket(max(2, max(len(ws) for s in states
                                                for ws in s["blocks"][level]["words"])))
                arr = np.zeros((R, G, LANES), np.uint32)
                for g, s in enumerate(states):
                    for j, ws in enumerate(s["blocks"][level]["words"]):
                        arr[: len(ws), g, j] = ws
                self.words.append(dev(arr.view(np.int32)))

            flat = [wfd.arm8_flat(s["arm"]) for s in states]
            self.wtr, self.btr, self.stw, self.stb = (
                dev(np.stack([f[k] for f in flat])) for k in range(4))
            self.dims = tuple((int(m.shape[0]), int(m.shape[1]))
                              for m in st0["arm"]["trunk_weights"])
            self.taps = wfd._tap_list(non_zero_pixel_ctx_index(cfg.spatial_context_arm))

            # Per-device-level IFCE fixed-point params stacked over the batch, and
            # for the wavefront kernel the int16 packing certificate |ctx| <=
            # (|b| + 64*2^8*sum|W|) >> 8 (+1 for the floor of the arithmetic
            # shift), which must hold for every image of the batch to pack two
            # features per int32 word.
            self.ifce_ws, self.ifce_bs, fits = {}, {}, {}
            for level in on_device:
                if self.n_ifce == 0 or cfg.input_features_ifce[level] == 0:
                    continue
                per_w, per_b, fits[level] = [], [], True
                for s in states:
                    fp = _ifce_fixed_params(s["nn"], cfg, s["header"], level, model=1)
                    per_w.append(np.asarray(fp["trunk_weights"][0], np.int32))
                    per_b.append(np.asarray(fp["trunk_biases"][0], np.int32))
                    bound = (np.abs(per_b[-1].astype(np.float64))
                             + 64.0 * 256.0 * np.abs(per_w[-1].astype(np.float64)).sum(0)
                             ) / 256.0 + 1.0
                    fits[level] = fits[level] and bool(bound.max() < 32768.0)
                self.ifce_ws[level] = dev(np.stack(per_w))
                self.ifce_bs[level] = dev(np.stack(per_b))
            # a zero context packs trivially
            self.packed_per_level = tuple(self.n_ifce > 0 and fits.get(level, True)
                                          for level in self.device_levels)
            self.host_grids = {
                level: dev(np.stack([np.asarray(s["decoded"][level], np.int32)
                                     for s in states]))
                for level in self.host_levels}

            # the small grids: one job table, stream table and words buffer,
            # the grids with no IFCE inputs first (one launch), then each
            # level with IFCE inputs (one launch each, its context made on
            # the device at the next level's size [G, h_c * w_c, n_ifce]).
            # small_runs: (levels, first job, end job) of each launch.
            ifce_free = tuple(lv for lv in self.small_levels if lv not in self.ifce_ws)
            runs = ([ifce_free] if ifce_free else []) + [
                (lv,) for lv in self.small_levels if lv in self.ifce_ws]
            grids, self.small_runs, self.small_offsets = [], [], {}
            for run in runs:
                self.small_runs.append((run, len(grids), len(grids) + len(run) * G))
                for level in run:
                    h_i, w_i = cfg.size_per_latent[level]
                    h_c, w_c = (cfg.size_per_latent[level + 1] if level in self.ifce_ws
                                else (0, 0))
                    for g, s in enumerate(states):
                        grids.append({"h": h_i, "w": w_i, "image": g,
                                      "words": s["blocks"][level]["words"],
                                      "ifce_off": g * h_c * w_c * self.n_ifce if w_c else -1,
                                      "ifce_w": w_c})
            if grids:
                p = sgd.pack(grids)
                self.small_jobs_np = p["jobs"]
                self.small_jobs, self.small_streams, self.small_words = (
                    dev(p[k]) for k in ("jobs", "streams", "words"))
                self.small_out_size = p["out_size"]
                for run, j0, _ in self.small_runs:
                    for i, level in enumerate(run):
                        self.small_offsets[level] = int(p["jobs"][j0 + i * G, 5])

        # float tail: one (Upsampling, Synthesis) per image
        with trace.span("decode.prepare.modules"):
            self.modules = [params_from_jax(s["nn"], cfg, device) for s in states]

    def small_run_inputs(self, run: int, decoded: dict) -> tuple[list, dict]:
        """Inputs of the launch of small_runs[run] for the whole batch:
        ([jobs, streams, words, wtr, btr, stw, stb, ifce], keywords) for
        ops/small_grid_decode.small_grid_decode, with the IFCE context of a
        level computed on the device from `decoded` (level -> [G, h, w]
        int32 grids of the coarser levels) in the span decode.ifce."""
        cfg = self.cfg
        levels, j0, j1 = self.small_runs[run]
        ifce = None
        if levels[0] in self.ifce_ws:
            with trace.span("decode.ifce"):
                finer = [decoded[l] for l in range(levels[0] + 1, cfg.n_latent_grids)]
                ifce = _ifce_ctx_device(finer, cfg, self.ifce_ws[levels[0]],
                                        self.ifce_bs[levels[0]])[0].reshape(-1)
        tensors = [self.small_jobs[j0:j1], self.small_streams, self.small_words, self.wtr,
                   self.btr, self.stw, self.stb, ifce]
        return tensors, dict(jobs_np=self.small_jobs_np[j0:j1], taps=self.taps, dims=self.dims,
                             n_ifce=self.n_ifce)

    def decode_small_run(self, run: int, decoded: dict, out: torch.Tensor) -> None:
        """Launch small_runs[run] into `out` (the small grids' flat int32
        buffer) inside the span decode.small_grids, and add its grids to
        `decoded` (every coarser level already there)."""
        with trace.span("decode.small_grids"):
            tensors, kw = self.small_run_inputs(run, decoded)
            sgd.small_grid_decode(*tensors, out, **kw)
        for level in self.small_runs[run][0]:
            h_i, w_i = self.cfg.size_per_latent[level]
            off = self.small_offsets[level]
            decoded[level] = out[off:off + self.G * h_i * w_i].view(self.G, h_i, w_i)

    def kernel_inputs(self, li: int, decoded: dict) -> tuple[list, dict]:
        """Inputs of the wavefront decode of device level self.device_levels[li]
        for the whole batch: ([words, wtr, btr, stw, stb, ifce], keywords),
        with the IFCE context computed on the device from `decoded` (level
        -> [G, h, w] int32 grids of the coarser levels)."""
        cfg, G = self.cfg, self.G
        level = self.device_levels[li]
        h_i, w_i = cfg.size_per_latent[level]
        packed = self.packed_per_level[li]
        rows = max((self.n_ifce + 1) // 2 if packed else self.n_ifce, 1)
        with trace.span("decode.ifce"):
            if self.n_ifce > 0 and cfg.input_features_ifce[level] > 0:
                finer = [decoded[l] for l in range(level + 1, cfg.n_latent_grids)]
                ctx, hc, wc = _ifce_ctx_device(finer, cfg, self.ifce_ws[level],
                                               self.ifce_bs[level])
                sheared = _shear_ifce(ctx, h_i, w_i, hc, wc, packed)
            else:
                sheared = torch.zeros((wfd.n_wavefronts(h_i, w_i), rows, G, LANES),
                                      dtype=torch.int32, device=self.device)
        tensors = [self.words[li], self.wtr, self.btr, self.stw, self.stb, sheared]
        kw = dict(h=h_i, w=w_i, taps=self.taps, dims=self.dims, n_ifce=self.n_ifce,
                  ifce_packed=packed)
        return tensors, kw

    @trace.spanned("decode.device")
    def run(self) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """All device levels and the float tail. Returns (raw [G, C, H, W]
        f32, grids: one [G, h, w] int32 tensor per level), on the device."""
        cfg, G = self.cfg, self.G
        decoded = dict(self.host_grids)
        with torch.no_grad():
            if self.small_runs:
                small_out = torch.empty(self.small_out_size, dtype=torch.int32,
                                        device=self.device)
            # the small grids with no IFCE inputs first, then every other
            # device level, coarse -> fine
            runs = {levels[0]: r for r, (levels, _, _) in enumerate(self.small_runs)}
            for level in sorted(set(self.small_levels) | set(self.device_levels),
                                reverse=True):
                if level in runs:
                    self.decode_small_run(runs[level], decoded, small_out)
                if level not in self.device_levels:
                    continue
                li = self.device_levels.index(level)
                (words, wtr, btr, stw, stb, ifce), kw = self.kernel_inputs(li, decoded)
                limit = wfd.grid_batch_limit(kw["h"], kw["w"], ifce.shape[1],
                                             words.shape[0], G, self.device)
                with trace.span("decode.kernel"):
                    outs = []
                    for g0 in range(0, G, limit):
                        g1 = min(G, g0 + limit)
                        outs.append(wfd.wavefront_decode(
                            words[:, g0:g1].contiguous(), wtr[g0:g1], btr[g0:g1],
                            stw[g0:g1], stb[g0:g1], ifce[:, :, g0:g1].contiguous(), **kw))
                    decoded[level] = torch.cat(outs) if len(outs) > 1 else outs[0]

            with trace.span("decode.float_tail"):
                syn_grids = [decoded[l].float() for l in range(cfg.n_latent_grids)
                             if not cfg.flag_is_hyperlatent[l]]
                dense = upsampling_batched([m[0] for m in self.modules], syn_grids)
                syn_out = synthesis_batched([m[1] for m in self.modules], dense)
                raw = interpolate(syn_out, cfg.img_size, cfg.final_upsampling_type)
        return raw, [decoded[l] for l in range(cfg.n_latent_grids)]

    def decode(self) -> list[tuple[np.ndarray, list[np.ndarray]]]:
        """run(), brought back to the host: [(raw_out [1, C, H, W], int64
        grids largest first), ...] in item order."""
        raw, grids = self.run()
        with trace.span("decode.copy_out"):
            raw_np = raw.cpu().numpy()
            grids_np = [g.cpu().numpy() for g in grids]
        if trace.on():
            trace.count("decode.d2h_bytes", raw_np.nbytes + sum(g.nbytes for g in grids_np))
        return [(raw_np[g:g + 1], [gr[g].astype(np.int64) for gr in grids_np])
                for g in range(self.G)]


@trace.spanned("decode.prepare")
def prepare_batch(items: list[tuple[CoolChicHeader, bytes, bytes]],
                  device: str | torch.device = "cuda") -> DeviceBatch:
    """items: (header, bytes_nn, bytes_latent) per image; all must share one
    architecture group. Raises ValueError for what the device path does not
    take (mixed groups, common randomness, a failed IFCE certificate): the
    caller then decodes the group on the host."""
    dev = resolve_device(device)
    states = []
    key0 = None
    for header, bytes_nn, bytes_latent in items:
        cfg = header.to_config()
        key = _group_key(cfg)
        if key0 is None:
            key0 = key
        elif key != key0:
            raise ValueError("device batch requires one architecture group")
        if cfg.flag_common_randomness:
            raise ValueError("common-randomness decode takes the host path")
        with trace.span("decode.prepare.nn"):
            nn = decode_network(bytes_nn, cfg, header.nn_q_step_shift,
                                header.nn_expgol_cnt, header.nn_n_bit_pad)
            arm = _main_arm_params(nn, header, cfg, 1)
        with trace.span("decode.prepare.blocks"):
            blocks = _parse_level_blocks(cfg, bytes_latent)
        states.append({"cfg": cfg, "header": header, "nn": nn, "arm": arm, "blocks": blocks})

    # int32 certificate of the on-device IFCE forward against raw symbol
    # inputs (the main ARM's certificate is the encoder's, per grid).
    with trace.span("decode.prepare.certificate"):
        for s in states:
            cfg = s["cfg"]
            if cfg.flag_ifce:
                for level in ifce_arm_index(cfg.input_features_ifce):
                    fp = _ifce_fixed_params(s["nn"], cfg, s["header"], level, model=1)
                    dim_in = fp["trunk_weights"][0].shape[0]
                    if not arm8_bounds_ok(fp, np.full(dim_in, 64.0 * 256.0)):
                        raise ValueError("IFCE int32 certificate failed; host path")

    return DeviceBatch(states, dev)


def decode_images_device(items: list[tuple[CoolChicHeader, bytes, bytes]],
                         device: str | torch.device = "cuda"
                         ) -> list[tuple[np.ndarray, list[np.ndarray]]]:
    """Device decode of one architecture group: [(raw_out [1, C, H, W] np,
    int64 grids largest first), ...] in item order."""
    return prepare_batch(items, device).decode()
