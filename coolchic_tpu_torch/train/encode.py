"""One image's encode: the training target, the image statistics of the
synthesis output transform, and the per-image pipeline (warm-up tournament
-> training phases -> NN quantization -> RDOQ -> bitstream write).

Reference parity: coolchic_tpu/train/encode.py.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.encode import encode_frame
from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.device import resolve_device
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.yuv import convert_420_to_444
from coolchic_tpu_torch.models.frame import FrameConfig, frame_cr_grids, frame_encoder_init
from coolchic_tpu_torch.models.params import tree_from_numpy, tree_to_numpy
from coolchic_tpu_torch.train.presets import Preset
from coolchic_tpu_torch.train.train import (
    EncoderMonitor,
    TorchNoise,
    _frame_phase_generator,
    test,
    train,
)
from coolchic_tpu_torch.utils.codingstructure import CodingStructure


def _target_from_frame(frame: FrameData, device: torch.device | str = "cpu"):
    """[1, C, H, W] target (a batch of one image), or a dict of planes."""
    if frame.frame_data_type == "yuv420":
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in frame.data.items()}
    return torch.as_tensor(np.asarray(frame.data, np.float32), device=device)


def img_min_max(frame: FrameData) -> Optional[np.ndarray]:
    """Per-channel (min, max) stats for the YUV output transform
    (reference component/video.py:93-101 initializes the synthesis output
    transform from image statistics for YUV content); None for RGB."""
    if frame.frame_data_type == "rgb":
        return None
    if frame.frame_data_type == "yuv420":
        data = convert_420_to_444(frame.data)
    else:
        data = np.asarray(frame.data)
    mn = data.min(axis=(0, 2, 3))
    mx = data.max(axis=(0, 2, 3))
    return np.stack([mn, mx], axis=1).astype(np.float32)


def encode_image(frame: FrameData, cfgs: dict[str, CoolChicConfig], preset: Preset, *,
                 seed: int = 0, verbose: bool = True, rdoq: bool = True,
                 device: str | torch.device = "cuda") -> tuple:
    """Overfit one I frame on `device`: the warm-up tournament, each main
    phase through the serial trainer train.train(), NN quantization, RDOQ
    and the decoder-side test. Returns (params (numpy), fcfg, nn_side_info,
    logs). Noise and initial weights come from the generators of a frame
    at display order 0 (train.train._frame_phase_generator)."""
    # the video and warm-up modules import this one
    from coolchic_tpu_torch.train.video import _quantize_frame
    from coolchic_tpu_torch.train.warmup import warmup_batched

    dev = resolve_device(device)
    fcfg = FrameConfig(coolchic_cfg=cfgs, frame_type="I",
                       frame_data_type=frame.frame_data_type, bitdepth=frame.bitdepth)
    target = _target_from_frame(frame, dev)
    cr = frame_cr_grids(fcfg, dev)
    monitor = EncoderMonitor(device=dev)

    n_candidates = preset.warmup.phases[0].candidates if preset.warmup.phases else 1
    gen = _frame_phase_generator(seed, 0, -2, dev)
    candidates = [frame_encoder_init(gen, fcfg, img_min_max(frame), device=dev)
                  for _ in range(n_candidates)]
    if preset.warmup.phases:
        t0 = time.time()
        params = warmup_batched(candidates, preset, fcfg, target,
                                noise_source=TorchNoise(_frame_phase_generator(seed, 0, -1, dev)),
                                cr=cr, monitor=monitor, verbose=verbose)
        if verbose:
            print(f"warm-up done in {time.time() - t0:.1f}s", flush=True)
    else:
        params = candidates[0]

    for idx, phase in enumerate(preset.training_phases):
        t0 = time.time()
        params = train(params, fcfg, target, phase,
                       noise_source=TorchNoise(_frame_phase_generator(seed, 0, idx, dev)),
                       cr=cr, monitor=monitor, verbose=verbose)
        if verbose:
            print(f"phase {idx} done in {time.time() - t0:.1f}s", flush=True)

    params, nn_side_info = _quantize_frame(tree_to_numpy(params), fcfg, preset, target, frame,
                                           monitor, verbose, dev, rdoq=rdoq, cr=cr)
    phase0 = preset.training_phases[-1]
    logs = test(tree_from_numpy(params, dev), fcfg, target, cr=cr,
                dist_weight=phase0.dist_weight, lmbda=phase0.lmbda)
    if verbose:
        print(f"final: psnr {logs.psnr_db:.3f} dB, latent {logs.total_rate_latent_bpp:.4f} "
              f"bpp, training iters {monitor.iterations_counter}, time "
              f"{monitor.total_training_time_sec:.1f}s", flush=True)
    return params, fcfg, nn_side_info, logs


def encode_image_to_bitstream(frame: FrameData, cfgs: dict[str, CoolChicConfig], preset: Preset,
                              bitstream_path: str, *, seed: int = 0, verbose: bool = True,
                              rdoq: bool = True, profile: str = "ref",
                              device: str | torch.device = "cuda") -> dict:
    """encode_image, then the one-frame bitstream written to
    `bitstream_path`; returns psnr_db, rate_bpp, latent_rate_bpp and
    n_bytes."""
    params, fcfg, nn_side_info, logs = encode_image(frame, cfgs, preset, seed=seed,
                                                    verbose=verbose, rdoq=rdoq, device=device)
    payload = encode_frame(params, fcfg, CodingStructure(n_frames=1, intra_pos=[0]),
                           nn_side_info, is_first_frame=True, profile=profile)
    with open(bitstream_path, "wb") as f:
        f.write(payload)
    return {
        "psnr_db": logs.psnr_db,
        "rate_bpp": 8 * len(payload) / frame.n_pixels,
        "latent_rate_bpp": logs.total_rate_latent_bpp,
        "n_bytes": len(payload),
    }
