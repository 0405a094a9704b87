"""Shared encode/decode core for one cool-chic decoder.

Decode pipeline (all integer up to the synthesis):
  header -> NN params (exp-Golomb) -> fixed-point ARM -> per-grid IFCE
  context -> range decode -> float upsampling + synthesis + final rescale
  on the requested device.

`ref` profile: one constriction stream, decoded by the host C++ (int64 X.16
ARM, f64 Laplace CDF). `tpu` profile: per-grid 128-stream payloads, decoded
by the batched device path (bitstream/device_decode.py, the CUDA wavefront
kernel), with the host C++ for the grids and groups it does not cover.

Reference parity: coolchic/bitstream/component/coolchic.py:29-207 and
coolchic_tpu/bitstream/codec.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.bitstream import rangecoder as rc
from coolchic_tpu_torch.bitstream.fixedpoint import (
    IFCE_OUTPUT_SHIFT,
    arm_to_fixed_point,
)
from coolchic_tpu_torch.bitstream.headers import CoolChicHeader
from coolchic_tpu_torch.bitstream.nncodec import decode_network
from coolchic_tpu_torch.bitstream.tpu_cdf import arm8_bounds_ok, arm8_from_int_layers
from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.constants import non_zero_pixel_ctx_index
from coolchic_tpu_torch.core.device import resolve_device
from coolchic_tpu_torch.core.noise import common_randomness_grids
from coolchic_tpu_torch.models.arm import ifce_arm_index
from coolchic_tpu_torch.models.params import params_from_jax
from coolchic_tpu_torch.models.synthesis import synthesis_batched
from coolchic_tpu_torch.models.upsampling import fixed_upsampling, upsampling_batched
from coolchic_tpu_torch.ops.resize import interpolate


def _nearest_x2_int(x: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(x, 2, axis=-2), 2, axis=-1)


def _fixed_upsampling_nearest_int(grids: list[np.ndarray]) -> np.ndarray:
    """Dense [C, h, w] nearest-upsampled stack of already-decoded int grids
    (largest grid first in `grids`)."""
    rev = list(reversed(grids))
    acc = rev[0][None]
    for target in rev[1:]:
        if acc.shape[-2:] != target.shape[-2:]:
            x = _nearest_x2_int(acc)[:, : target.shape[-2], : target.shape[-1]]
        else:
            x = acc
        acc = np.concatenate([target[None], x], axis=0)
    return acc


def _ifce_fixed_params(nn_params: dict, cfg: CoolChicConfig, header: CoolChicHeader,
                       idx_latent: int, model: int = 0) -> dict:
    arm_idx = ifce_arm_index(cfg.input_features_ifce)[idx_latent]
    ifce_arm = nn_params["ifce"]["arms"][arm_idx]
    kw = dict(stabiliser=None, subtract_last_layer=False, n_inter_ft_ctx=0,
              no_residual_layer=True)
    to_fp = arm8_from_int_layers if model == 1 else arm_to_fixed_point
    return to_fp(ifce_arm["layers"],
                 header.nn_q_step_shift[("ifce", "weight")],
                 header.nn_q_step_shift[("ifce", "bias")], **kw)


def _ifce_context_for_grid(nn_params: dict, cfg: CoolChicConfig, header: CoolChicHeader,
                           idx_latent: int, decoded: list[np.ndarray],
                           h_i: int, w_i: int, model: int = 0) -> Optional[np.ndarray]:
    """int64 [h_i * w_i, C_f] IFCE context (X.8) for the grid being
    (de)coded, or None when the architecture has no IFCE at all. model 1 =
    tpu-profile X.8 int32 pipeline (tpu_cdf.py), model 0 = reference X.16."""
    if not cfg.flag_ifce:
        return None

    if idx_latent == cfg.n_latent_grids - 1:
        ups = np.zeros((1, h_i, w_i), dtype=np.int64)
    else:
        ups = _fixed_upsampling_nearest_int(decoded)

    c, h, w = ups.shape
    if cfg.input_features_ifce[idx_latent] == 0:
        ctx = np.zeros((h * w, cfg.output_feature_ifce), dtype=np.int64)
    else:
        flat = ups.reshape(c, h * w).T  # [(h w), c]
        fp = _ifce_fixed_params(nn_params, cfg, header, idx_latent, model=model)
        out_shift, act_shift = (8, 8) if model == 1 else (IFCE_OUTPUT_SHIFT, 16)
        ctx = rc.arm_forward_native(flat, fp, out_shift, act_shift=act_shift)

    ctx = ctx.T.reshape(-1, h, w)
    ctx = _nearest_x2_int(ctx)[:, :h_i, :w_i]
    return ctx.reshape(-1, h_i * w_i).T.copy()


def _main_arm_params(nn_params: dict, header: CoolChicHeader, cfg: CoolChicConfig,
                     model: int) -> dict:
    kw = dict(stabiliser=nn_params["arm"].get("stabiliser"),
              subtract_last_layer=True, n_inter_ft_ctx=cfg.output_feature_ifce)
    to_fp = arm8_from_int_layers if model == 1 else arm_to_fixed_point
    return to_fp(nn_params["arm"]["layers"],
                 header.nn_q_step_shift[("arm", "weight")],
                 header.nn_q_step_shift[("arm", "bias")], **kw)


def _arm8_in_bound(arm_fp: dict, ifce_ctx: Optional[np.ndarray]) -> np.ndarray:
    """Per-column input bound (X.8) for the int32 ARM certificate: spatial
    columns are symbols in [-64, 63] shifted to X.8 (<= 64 * 2^8); IFCE
    columns are UNCLAMPED network outputs, so their bound is the actual
    per-column max |ifce_ctx| of the grid being coded."""
    dim = arm_fp["trunk_weights"][0].shape[0]
    n_ifce = 0 if ifce_ctx is None else int(ifce_ctx.shape[-1])
    in_bound = np.full(dim, 64.0 * 256.0)
    if n_ifce:
        in_bound[dim - n_ifce:] = np.abs(
            ifce_ctx.reshape(-1, n_ifce)).max(axis=0).astype(np.float64)
    return in_bound


def _check_arm8_certificate(arm_fp: dict, ifce_ctx: Optional[np.ndarray]) -> None:
    """The tpu profile requires every int32 X.8 ARM intermediate to stay in
    range (it is what lets the wavefront kernel run pure int32). Checked per
    grid against the actual IFCE context magnitudes."""
    if not arm8_bounds_ok(arm_fp, _arm8_in_bound(arm_fp, ifce_ctx)):
        raise RuntimeError(
            "tpu-profile int32 ARM certificate failed (pathological quantized "
            "weights or IFCE magnitudes); re-encode with --profile ref")


def grid_n_streams(h: int, w: int) -> int:
    """`tpu`-profile stream count per grid: 128 streams on big grids,
    minimal sealing overhead on small ones."""
    n = h * w
    if n >= 1 << 16:
        return 128
    if n >= 1 << 10:
        return 8
    return 1


def synthesize(nn_params: dict, cfg: CoolChicConfig, latent_grids: list[np.ndarray],
               device: str | torch.device = "cuda") -> np.ndarray:
    """Float decode tail on `device`: learned upsampling + synthesis + final
    rescale. latent_grids: decoded integer grids (largest first), all of
    them (hyperlatents are filtered here). Returns [1, C_out, H, W] f32."""
    dev = resolve_device(device)
    ups, syn = params_from_jax(nn_params, cfg, dev)
    grids = [torch.as_tensor(np.asarray(g, np.float32), device=dev)[None]
             for g, hyper in zip(latent_grids, cfg.flag_is_hyperlatent) if not hyper]
    with torch.no_grad():
        syn_in = upsampling_batched([ups], grids)
        if cfg.flag_common_randomness:
            cr = [torch.as_tensor(g, device=dev)
                  for g in common_randomness_grids(list(cfg.size_per_latent_cr))]
            noise = interpolate(fixed_upsampling(cr, mode="bicubic"), cfg.img_size,
                                "bicubic")
            syn_in = torch.cat([syn_in, noise[None]], dim=1)
        out = interpolate(synthesis_batched([syn], syn_in), cfg.img_size,
                          cfg.final_upsampling_type)
    return out.cpu().numpy()


def decode_tpu_level_host(nn_params: dict, cfg: CoolChicConfig, header: CoolChicHeader,
                          arm8: dict, level: int, words: list[np.ndarray],
                          decoded: list[np.ndarray]) -> np.ndarray:
    """Range-decode one `tpu`-profile grid on the host (C++) from its streams'
    u32 words; its IFCE context comes from `decoded`, the coarser grids
    (largest first)."""
    h_i, w_i = cfg.size_per_latent[level]
    ifce_ctx = _ifce_context_for_grid(nn_params, cfg, header, level, decoded, h_i, w_i,
                                      model=1)
    decs = [rc.RangeDecoder(np.asarray(ws).tobytes()) for ws in words]
    return rc.code_grid_streams(decs, False, h_i, w_i, cfg.spatial_context_arm,
                                ifce_ctx, arm8,
                                non_zero_pixel_ctx_index(cfg.spatial_context_arm),
                                model=1)


def decode_coolchic_tpu_host(header: CoolChicHeader, bytes_nn: bytes,
                             bytes_latent: bytes, device: str | torch.device = "cuda"
                             ) -> tuple[np.ndarray, list[np.ndarray]]:
    """`tpu`-profile decode with every grid range-decoded on the host (the
    route for groups the device path does not take); float tail on
    `device`."""
    from coolchic_tpu_torch.bitstream.device_decode import _parse_level_blocks

    cfg = header.to_config()
    nn_params = decode_network(bytes_nn, cfg, header.nn_q_step_shift,
                               header.nn_expgol_cnt, header.nn_n_bit_pad)
    arm8 = _main_arm_params(nn_params, header, cfg, 1)
    blocks = _parse_level_blocks(cfg, bytes_latent)
    decoded: list[np.ndarray] = []  # largest first
    for level in range(cfg.n_latent_grids - 1, -1, -1):
        decoded.insert(0, decode_tpu_level_host(nn_params, cfg, header, arm8, level,
                                                blocks[level]["words"], decoded))
    return synthesize(nn_params, cfg, decoded, device), decoded


def decode_coolchic(header: CoolChicHeader, bytes_nn: bytes, bytes_latent: bytes,
                    profile: str = "ref", device: str | torch.device = "cuda"
                    ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Returns (raw synthesis output [1, C, H, W], decoded integer grids).
    profile "tpu" goes through the batched device decode
    (bitstream/decode.py:_decode_items_batched)."""
    if profile == "tpu":
        from coolchic_tpu_torch.bitstream.decode import _decode_items_batched

        outputs, _ = _decode_items_batched([(header, bytes_nn, bytes_latent)], device)
        return outputs[0]

    cfg = header.to_config()
    nn_params = decode_network(bytes_nn, cfg, header.nn_q_step_shift,
                               header.nn_expgol_cnt, header.nn_n_bit_pad)

    arm_fp = _main_arm_params(nn_params, header, cfg, 0)
    ctx_idx = non_zero_pixel_ctx_index(cfg.spatial_context_arm)

    decoder = rc.RangeDecoder(bytes_latent)
    decoded: list[np.ndarray] = []  # largest first
    for idx_latent in range(cfg.n_latent_grids - 1, -1, -1):
        h_i, w_i = cfg.size_per_latent[idx_latent]
        ifce_ctx = _ifce_context_for_grid(nn_params, cfg, header, idx_latent, decoded,
                                          h_i, w_i, model=0)
        grid = rc.code_grid(decoder, False, h_i, w_i, cfg.spatial_context_arm,
                            ifce_ctx, arm_fp, ctx_idx)
        decoded.insert(0, grid)

    return synthesize(nn_params, cfg, decoded, device), decoded


def encode_coolchic_latents(header: CoolChicHeader, nn_params_int: dict,
                            quantized_latents: list[np.ndarray],
                            profile: str = "ref") -> bytes:
    """Range-encode the quantized latent grids (coarse to fine) given the
    already-quantized integer NN params. Returns the latent byte payload and
    sets header.n_bytes_latent.

    profile "ref": one constriction stream for the whole payload (reference
    bit-compatible). profile "tpu": per grid, [u8 n_streams][n x u32 word
    counts][stream words...] with row-keyed streams (docs/tpu_profile.md)."""
    cfg = header.to_config()
    model = 1 if profile == "tpu" else 0
    arm_fp = _main_arm_params(nn_params_int, header, cfg, model)
    ctx_idx = non_zero_pixel_ctx_index(cfg.spatial_context_arm)

    encoder = rc.RangeEncoder() if profile == "ref" else None
    chunks: list[bytes] = []
    coded: list[np.ndarray] = []
    for idx_latent in range(cfg.n_latent_grids - 1, -1, -1):
        h_i, w_i = cfg.size_per_latent[idx_latent]
        ifce_ctx = _ifce_context_for_grid(nn_params_int, cfg, header, idx_latent, coded,
                                          h_i, w_i, model=model)
        if model == 1:
            _check_arm8_certificate(arm_fp, ifce_ctx)
        data = np.ascontiguousarray(quantized_latents[idx_latent], dtype=np.int64)
        if profile == "ref":
            out = rc.code_grid(encoder, True, h_i, w_i, cfg.spatial_context_arm,
                               ifce_ctx, arm_fp, ctx_idx, data=data)
        else:
            n_streams = grid_n_streams(h_i, w_i)
            encoders = [rc.RangeEncoder() for _ in range(n_streams)]
            out = rc.code_grid_streams(encoders, True, h_i, w_i,
                                       cfg.spatial_context_arm, ifce_ctx, arm_fp,
                                       ctx_idx, data=data, model=model)
            streams = [e.get_bytes() for e in encoders]
            counts = np.array([len(s) // 4 for s in streams], dtype="<u4")
            chunks.append(bytes([n_streams]) + counts.tobytes() + b"".join(streams))
        coded.insert(0, out)

    payload = encoder.get_bytes() if profile == "ref" else b"".join(chunks)
    header.n_bytes_latent = len(payload)
    return payload
