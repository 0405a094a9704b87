"""Per-frame encode pipeline for I, P and B frames:

  1. load the original frame and, for P/B, its DECODED references (from
     the workdir);
  2. [P/B] global translation search, flow-guided motion pretraining
     (pyramidal LK standing in for RAFT, models/flow.py);
  3. warm-up tournament (the odd inter candidates preloaded with the
     pretrained motion decoder);
  4. training phases, NN quantization, RDOQ, bitstream write;
  5. save the decoded frame (later frames reference it) and the logs.

The GOP driver encode_video walks the frames in coding order with the
reference's per-depth rules (operating points, λ · 1.5^depth, shrinking
iteration budgets for B frames), or, with waves=True, encodes each
dependency wave's same-depth frames as one batch (encode_wave_group): the
frames become batch slots of the main phases, each slot with its own
references and its own noise stream, so a frame trains alike in a wave and
alone.

The port of coolchic_tpu/train/video.py (encode_one_frame, _prep_frame,
guided_motion_pretraining, _rdoq_frame_ctx, _quantize_frame,
_finalize_frame, encode_wave_group, frame_cfg_args, _frame_preset,
encode_video). Every stage runs on the requested device; the host does
the global translation search (numpy, as the JAX package), the SOAP eigh
seeding, the NN quantization and RDOQ bookkeeping and the range coding. The
main phases run the batched window at n = 1 (the references ride its batch
axis), or, for a config with common randomness (--tune wasserstein), the
serial trainer train.train(), as the JAX package chooses.

Noise and initial weights come from torch.Generators seeded from (seed,
display order, phase index), the role of _frame_phase_key in the JAX
package; the streams differ from JAX's PRNG, so the port's encode of an
image is not the JAX encode's bit for bit, only its equal in RD terms.

Not ported yet: the spatial mesh.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.encode import encode_frame
from coolchic_tpu_torch.core.device import resolve_device
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.io.io import load_frame_data_from_file, save_frame_data_to_file
from coolchic_tpu_torch.io.yuv import convert_420_to_444
from coolchic_tpu_torch.models.coolchic import coolchic_forward
from coolchic_tpu_torch.models.flow import estimate_flow
from coolchic_tpu_torch.models.frame import (
    FrameConfig,
    frame_cr_grids,
    frame_encoder_forward,
    frame_encoder_init,
)
from coolchic_tpu_torch.models.globalmotion import get_global_translation
from coolchic_tpu_torch.models.params import tree_from_numpy, tree_to_numpy
from coolchic_tpu_torch.models.warp import shift_references, warp_fn
from coolchic_tpu_torch.nnquant.quantize import quantize_coolchic
from coolchic_tpu_torch.nnquant.rdoq import rdoq_coolchic
from coolchic_tpu_torch.parallel.encode_batch import _batched_phase
from coolchic_tpu_torch.train.encode import _target_from_frame, img_min_max
from coolchic_tpu_torch.train.logs import (
    detailed_test,
    write_detailed_tsv,
    write_reference_encoder_tsv,
)
from coolchic_tpu_torch.train.params import tree_leaves, tree_map
from coolchic_tpu_torch.train.presets import Preset, PresetInter, PresetIntra
from coolchic_tpu_torch.train.train import (
    EncoderMonitor,
    PhaseFns,
    SlotNoise,
    TorchNoise,
    _frame_phase_generator,
    index_tree,
    stack_trees,
    test,
    train,
)
from coolchic_tpu_torch.train.warmup import warmup_batched
from coolchic_tpu_torch.utils.checkpoint import load_frame_encoder, save_frame_encoder
from coolchic_tpu_torch.utils.codingstructure import CodingStructure, Frame
from coolchic_tpu_torch.utils.parsecli import (
    coolchic_config_from_args,
    intra_operating_points,
    motion_operating_points,
    residue_operating_points,
    substitute_x_channels,
)
from coolchic_tpu_torch.utils.results import write_frame_results

# Pixel x trial budget of one batched NN-quantization eval.
_EVAL_BATCH_PX = 8_000_000


def intra_gain_for_lmbda(lmbda: float) -> int:
    """λ-adaptive intra encoder gain (reference video.py:80-91)."""
    if lmbda < 0.0002:
        return 24
    if lmbda < 0.0005:
        return 20
    return 16


def _decoded_name(display_idx: int, fdata: FrameData, video_path: str) -> str:
    """Decoded-frame filename: an image keeps its input's format (.ppm
    stays .ppm, which needs no PIL); yuv names carry the WxH / format
    convention the loader reads."""
    if video_path.endswith((".png", ".ppm")):
        return f"{display_idx:04d}-decoded{os.path.splitext(video_path)[1]}"
    h, w = fdata.img_size
    return (f"{display_idx:04d}-decoded_{w}x{h}_{fdata.frame_data_type}_"
            f"{fdata.bitdepth}b.yuv")


def _dense(frame: FrameData) -> np.ndarray:
    if frame.frame_data_type == "yuv420":
        return convert_420_to_444(frame.data)
    return np.asarray(frame.data)


def encode_one_frame(frame: Frame, coding_structure: CodingStructure, video_path: str,
                     workdir: str, preset: Preset, cfg_args: dict[str, dict],
                     warp_filter_size: int = 8, seed: int = 0, verbose: bool = True,
                     rdoq: bool = True, tune: str = "mse", profile: str = "ref",
                     device: str | torch.device = "cuda") -> dict:
    """Encode one I, P or B frame on `device`; returns {payload bytes,
    logs, detailed logs, ...}. A P/B frame's decoded references are read
    from the workdir; the decoded frame and the logs are written to it."""
    dev = resolve_device(device)
    fdata = load_frame_data_from_file(video_path, frame.display_order + frame.frame_offset)
    frame.data = fdata

    ckpt_path = os.path.join(workdir, f"{frame.display_order:04d}-frame_encoder.npz")
    if os.path.exists(ckpt_path):
        if verbose:
            print(f"frame {frame.display_order}: resuming from {ckpt_path}", flush=True)
        params, fcfg, nn_side_info = load_frame_encoder(ckpt_path)
        return _finalize_frame(frame, coding_structure, params, fcfg, nn_side_info,
                               fdata, workdir, video_path, verbose, profile=profile,
                               lmbda=preset.lmbda, device=dev)

    prep = _prep_frame(frame, fdata, workdir, video_path, preset, cfg_args,
                       warp_filter_size, seed, tune, dev, verbose)
    fcfg, target, monitor = prep["fcfg"], prep["target"], prep["monitor"]
    candidates, cr, refs = prep["candidates"], prep["cr"], prep["refs"]

    if preset.warmup.phases:
        noise = TorchNoise(_frame_phase_generator(seed, frame.display_order, -1, dev))
        with monitor.timed("warmup"):
            params = warmup_batched(candidates, preset, fcfg, target, noise_source=noise,
                                    cr=cr, refs=refs, monitor=monitor, verbose=verbose)
    else:
        params = candidates[0]

    # The main phases run the batched window at n = 1 with the frame's own
    # noise stream, as the JAX package's serial path does; a config with
    # common randomness runs them through the serial trainer, as the JAX
    # package does (its batched window carries no cr).
    if any(v is not None for v in cr.values()):
        for idx, phase in enumerate(preset.training_phases):
            noise = TorchNoise(_frame_phase_generator(seed, frame.display_order, idx, dev))
            with monitor.timed(f"train_phase_{idx}"):
                params = train(params, fcfg, target, phase, noise_source=noise, cr=cr,
                               refs=refs, monitor=monitor, verbose=verbose)
        params = tree_to_numpy(params)
    else:
        params_b = stack_trees([params])
        for idx, phase in enumerate(preset.training_phases):
            noise = TorchNoise(_frame_phase_generator(seed, frame.display_order, idx, dev))
            with monitor.timed(f"train_phase_{idx}"):
                params_b, _ = _batched_phase(params_b, target, fcfg, phase, monitor,
                                             verbose, noise_source=noise, refs_b=refs)
        params = tree_to_numpy(index_tree(params_b, 0))

    params, nn_side_info = _quantize_frame(params, fcfg, preset, target, fdata, monitor,
                                           verbose, dev, rdoq=rdoq, cr=cr, refs=refs)

    if verbose:
        print(f"frame {frame.frame_type}{frame.display_order}: "
              f"{monitor.iterations_counter} iters\n" + monitor.report(), flush=True)

    save_frame_encoder(ckpt_path, params, fcfg, nn_side_info)
    return _finalize_frame(frame, coding_structure, params, fcfg, nn_side_info,
                           fdata, workdir, video_path, verbose, profile=profile,
                           lmbda=preset.lmbda, monitor=monitor, device=dev)


def _load_refs(index_references, fdata: FrameData, workdir: str, video_path: str,
               device: torch.device) -> list:
    """The decoded references of a P/B frame from the workdir, dense (444
    for yuv420), one [1, 3, H, W] tensor each on `device`."""
    return [torch.as_tensor(np.asarray(_dense(load_frame_data_from_file(os.path.join(
        workdir, _decoded_name(i, fdata, video_path)))), np.float32), device=device)
        for i in index_references]


def guided_motion_pretraining(target_flows: torch.Tensor, motion_cfg, preset: Preset,
                              seed: int, display_order: int, device: torch.device,
                              monitor: EncoderMonitor, verbose: bool = False) -> dict:
    """Overfit the motion decoder to imitate the estimated flow(s)
    [1, 2 | 4, H, W] as a dense 'flow image' (reference video.py:399-469):
    an I-type "flow" frame at encoder gain 16, trained by the serial
    trainer. Returns the motion cool-chic's params (tensors, no batch
    axis)."""
    n_out = target_flows.shape[1]
    layers = substitute_x_channels(list(motion_cfg.layers_synthesis), n_out)
    pre_cfg = dataclasses.replace(motion_cfg, layers_synthesis=tuple(layers), encoder_gain=16)
    fcfg = FrameConfig(coolchic_cfg={"residue": pre_cfg}, frame_type="I",
                       frame_data_type="flow", bitdepth=8)
    params = frame_encoder_init(_frame_phase_generator(seed, display_order, -3, device),
                                fcfg, device=device)
    noise = TorchNoise(_frame_phase_generator(seed, display_order, -4, device))
    for phase in preset.motion_pretrain_phase:
        params = train(params, fcfg, target_flows, phase, noise_source=noise,
                       monitor=monitor, verbose=verbose)
    return params["residue"]


def _prep_frame(frame: Frame, fdata: FrameData, workdir: str, video_path: str,
                preset: Preset, cfg_args: dict[str, dict], warp_filter_size: int,
                seed: int, tune: str, device: torch.device, verbose: bool = False) -> dict:
    """Configs, target, references and warm-up candidates of one frame; for
    P/B the global translation search and the motion pretraining."""
    h, w = fdata.img_size
    monitor = EncoderMonitor(device=device)
    cfgs = {name: coolchic_config_from_args(args, (h, w), coolchic_name=name,
                                            frame_type=frame.frame_type, tune=tune)
            for name, args in cfg_args.items()
            if not (frame.frame_type == "I" and name == "motion")}
    if frame.frame_type == "I":
        # λ-adaptive encoder gain for intra (reference video.py:80-91).
        gain = intra_gain_for_lmbda(preset.lmbda)
        cfgs = {k: dataclasses.replace(v, encoder_gain=gain) for k, v in cfgs.items()}
    fcfg = FrameConfig(
        coolchic_cfg=cfgs, frame_type=frame.frame_type,
        frame_data_type=fdata.frame_data_type, bitdepth=fdata.bitdepth,
        index_references=tuple(frame.index_references),
        frame_display_index=frame.display_order, warp_filter_size=warp_filter_size)

    refs = None
    global_flows = [np.zeros(2, np.float32), np.zeros(2, np.float32)]
    pretrained_motion = None
    if frame.frame_type != "I":
        refs = _load_refs(frame.index_references, fdata, workdir, video_path, device)
        target_dense = _dense(fdata)
        with monitor.timed("global_translation"):
            shifted, flows = get_global_translation(
                target_dense, [r.cpu().numpy() for r in refs])
        global_flows[:len(flows)] = flows
        if verbose:
            print(f"global translation {[f.tolist() for f in flows]} "
                  f"({monitor.phase_time_sec['global_translation']:.1f}s)", flush=True)
        with monitor.timed("flow"):
            tgt_dev = torch.as_tensor(target_dense, device=device)
            est = torch.cat([estimate_flow(tgt_dev, torch.as_tensor(sr, device=device))
                             for sr in shifted], dim=1)
        if preset.motion_pretrain_phase and preset.motion_pretrain_phase[0].max_itr > 0:
            with monitor.timed("motion_pretrain"):
                pretrained_motion = guided_motion_pretraining(
                    est, cfgs["motion"], preset, seed, frame.display_order, device, monitor)
            # Rescale the latents if the final motion gain differs from 16.
            ratio = cfgs["motion"].encoder_gain / 16.0
            if ratio != 1.0:
                pretrained_motion = {**pretrained_motion, "latents": [
                    lat * ratio for lat in pretrained_motion["latents"]]}
            if verbose:
                print(f"motion pretraining done "
                      f"({monitor.phase_time_sec['motion_pretrain']:.1f}s)", flush=True)

    # Stats-based output transform for intra frames only (reference
    # video.py:84-101).
    stats = img_min_max(fdata) if frame.frame_type == "I" else None
    n_candidates = preset.warmup.phases[0].candidates if preset.warmup.phases else 1
    gen = _frame_phase_generator(seed, frame.display_order, -2, device)
    candidates = []
    for i in range(n_candidates):
        p = frame_encoder_init(gen, fcfg, stats, device=device)
        p["global_flow_1"] = torch.as_tensor(global_flows[0], device=device)
        p["global_flow_2"] = torch.as_tensor(global_flows[1], device=device)
        # odd candidates start from the pretrained motion (reference
        # video.py:179-212); with no tournament the single candidate takes it
        if pretrained_motion is not None and (i % 2 or n_candidates == 1):
            p["motion"] = pretrained_motion
        candidates.append(p)
    return {"fcfg": fcfg, "target": _target_from_frame(fdata, device),
            "cr": frame_cr_grids(fcfg, device), "refs": refs,
            "monitor": monitor, "candidates": candidates}


def _grid_scorer(params: dict, fcfg: FrameConfig, cc_name: str, target, lmbda: float,
                 dist_weight: dict, device: torch.device, cr: Optional[dict] = None,
                 refs: Optional[list] = None):
    """score(trials) for quantize_coolchic: the frame's eval loss (decoder's
    view, no NN rate) with cc `cc_name` replaced by each trial, the trials
    run as the batch axis in chunks of the _EVAL_BATCH_PX budget (a P/B
    frame's references broadcast over them). Leaves shared by every trial
    go to the device once and are broadcast."""
    fns = PhaseFns(fcfg, params, "none", "hardround", dist_weight,
                   (0.95, 0.95), (0.9, 0.999), 10, cr=cr)
    h, w = fcfg.cc_cfgs["residue"].img_size
    chunk = max(1, _EVAL_BATCH_PX // (h * w))
    on_device: dict[int, tuple] = {}

    def dev_leaf(x):
        if id(x) not in on_device:
            on_device[id(x)] = (x, torch.tensor(np.asarray(x), device=device))
        return on_device[id(x)][1]

    def score(trials: list[dict]) -> np.ndarray:
        losses = []
        for c0 in range(0, len(trials), chunk):
            trees = [{**params, cc_name: t} for t in trials[c0:c0 + chunk]]
            g = len(trees)
            leaves = []
            for xs in zip(*(tree_leaves(t) for t in trees)):
                if all(x is xs[0] for x in xs):
                    t0 = dev_leaf(xs[0])
                    leaves.append(t0[None].expand(g, *t0.shape))
                else:
                    leaves.append(torch.as_tensor(np.stack(xs), device=device))
            tgt = (tree_map(lambda t: t.expand(g, *t.shape[1:]), target)
                   if isinstance(target, dict) else target.expand(g, *target.shape[1:]))
            refs_g = None if refs is None else [r.expand(g, *r.shape[1:]) for r in refs]
            losses.append(fns.eval(leaves, tgt, lmbda, refs_g).loss)
        return torch.cat(losses).cpu().numpy()

    return score


def _rdoq_frame_ctx(params: dict, fcfg: FrameConfig, cc_name: str, refs: list,
                    cr: Optional[dict], device: torch.device) -> dict:
    """Fixed frame-level activations for RDOQ's P/B reconstruction scorers
    (nnquant/rdoq.py: rdoq_coolchic's frame_ctx). The other cool-chic is
    evaluated as it stands at this point of the quantization walk (float
    if not yet quantized, as the NN-quantization grid search sees it).
    `params`: numpy, no batch axis; `refs`: [1, 3, H, W] tensors."""
    like = tree_map(lambda x: x[None], tree_from_numpy(params, device))
    shifted = shift_references(refs, [like[f"global_flow_{i + 1}"]
                                      for i in range(len(refs))])
    other = "motion" if cc_name == "residue" else "residue"
    with torch.no_grad():
        raw = coolchic_forward(like[other], fcfg.cc_cfgs[other], training=False,
                               cr=None if cr is None else cr.get(other)).raw_out
        if cc_name == "residue":
            return {"role": "residue", "warps": tuple(
                warp_fn(r, raw[:, 2 * i:2 * i + 2], fcfg.warp_filter_size, training=False)
                for i, r in enumerate(shifted))}
    return {"role": "motion", "other_raw": raw, "refs": tuple(shifted),
            "warp_filter_size": fcfg.warp_filter_size}


def _quantize_frame(params: dict, fcfg: FrameConfig, preset: Preset, target,
                    fdata: FrameData, monitor: EncoderMonitor, verbose: bool,
                    device: torch.device, *, rdoq: bool = False,
                    cr: Optional[dict] = None, refs: Optional[list] = None
                    ) -> tuple[dict, dict]:
    """NN quantization (+ RDOQ) of every cool-chic in `params` (numpy), in
    order (residue, then motion, which sees the quantized residue); returns
    the quantized params and the per-cc (q_shift, expgol) side info. RDOQ
    refines synthesis and upsampling against the dense frame (444 for
    yuv420): the I residue alone, a P/B cool-chic with the other's
    contribution fixed (_rdoq_frame_ctx). It updates expgol in place."""
    phase0 = preset.training_phases[-1]
    nn_side_info = {}
    for cc_name in fcfg.cc_cfgs:
        score = _grid_scorer(params, fcfg, cc_name, target, phase0.lmbda,
                             phase0.dist_weight, device, cr=cr, refs=refs)
        with monitor.timed("nn_quantize"):
            q_params, q_shift, expgol, _ = quantize_coolchic(
                params[cc_name], fcfg.cc_cfgs[cc_name], score, phase0.lmbda,
                fdata.n_pixels, verbose=verbose)
        if rdoq:
            inter = fcfg.frame_type != "I"
            fctx = _rdoq_frame_ctx(params, fcfg, cc_name, refs, cr, device) if inter else None
            with monitor.timed("rdoq" if cc_name == "residue" else f"rdoq_{cc_name}"):
                q_params = rdoq_coolchic(
                    q_params, fcfg.cc_cfgs[cc_name], q_shift, expgol, phase0.lmbda,
                    target=_dense(fdata) if cc_name == "residue" or inter else None,
                    frame_type=fcfg.frame_type, frame_data_type=fdata.frame_data_type,
                    bitdepth=fdata.bitdepth, frame_ctx=fctx, verbose=verbose,
                    device=device)
        params = {**params, cc_name: q_params}
        nn_side_info[cc_name] = (q_shift, expgol)
    return params, nn_side_info


def _finalize_frame(frame: Frame, coding_structure: CodingStructure, params: dict,
                    fcfg: FrameConfig, nn_side_info: dict, fdata: FrameData,
                    workdir: str, video_path: str, verbose: bool,
                    profile: str = "ref", lmbda: float = 0.0,
                    monitor: Optional[EncoderMonitor] = None, *,
                    device: torch.device) -> dict:
    """Bitstream write + decoded-frame save + the summary results TSV and
    the detailed logs (shared between the fresh-encode and
    resume-from-checkpoint paths)."""
    monitor = monitor or EncoderMonitor(device=device)
    target = _target_from_frame(fdata, device)
    n_pixels = fdata.n_pixels
    params_dev = tree_from_numpy(params, device)
    cr = frame_cr_grids(fcfg, device)
    refs = (None if fcfg.frame_type == "I"
            else _load_refs(fcfg.index_references, fdata, workdir, video_path, device))

    logs = test(params_dev, fcfg, target, cr=cr, refs=refs)

    with monitor.timed("bitstream_write"):
        payload = encode_frame(params, fcfg, coding_structure, nn_side_info,
                               is_first_frame=frame.coding_order == 0, profile=profile)

    with torch.no_grad():
        out = frame_encoder_forward(tree_map(lambda x: x[None], params_dev), fcfg,
                                    reference_frames=refs, training=False, cr=cr)
    if fdata.frame_data_type == "yuv420":
        dec_data = {k: v.cpu().numpy() for k, v in out.decoded_image.items()}
    else:
        dec_data = out.decoded_image.cpu().numpy()
    decoded = FrameData(fdata.bitdepth, fdata.frame_data_type, dec_data)
    save_frame_data_to_file(decoded, os.path.join(
        workdir, _decoded_name(frame.display_order, fdata, video_path)))

    rate_bpp = 8 * len(payload) / n_pixels
    write_frame_results(
        os.path.join(workdir, f"{frame.display_order:04d}-results_encoder.tsv"),
        seq_name=frame.seq_name or os.path.basename(workdir), lmbda=lmbda,
        n_pixels=n_pixels, logs=logs, rate_bpp=rate_bpp,
        extra={"frame_type": fcfg.frame_type, "n_bytes": len(payload)})

    # Detailed per-frame logs (reference FrameEncoderLogs, training/test.py):
    # per-grid bpp, per-module NN bpp, MAC/px, alpha/beta stats, prediction
    # dB -- one wide TSV row next to the summary TSV, plus a column-identical
    # reference-schema results TSV.
    detailed = detailed_test(
        params, fcfg, target, refs=refs, cr=cr, lmbda=lmbda, nn_side_info=nn_side_info,
        encoding_time_second=monitor.total_training_time_sec,
        encoding_iterations_cnt=monitor.iterations_counter,
        display_order=frame.display_order, coding_order=frame.coding_order,
        frame_offset=frame.frame_offset,
        seq_name=frame.seq_name or os.path.basename(workdir), device=device)
    detailed["frame_type"] = fcfg.frame_type
    detailed["n_bytes"] = len(payload)
    write_reference_encoder_tsv(
        os.path.join(workdir, f"{frame.display_order:04d}-results_encoder_ref.tsv"),
        detailed)
    write_detailed_tsv(os.path.join(workdir, f"{frame.display_order:04d}-logs_detailed.tsv"),
                       detailed)
    if verbose:
        print(f"frame {fcfg.frame_type}{frame.display_order}: "
              f"psnr {logs.psnr_db:.3f} dB, {rate_bpp:.4f} bpp "
              f"({len(payload)} bytes)", flush=True)

    return {"payload": payload, "logs": logs, "decoded": decoded,
            "n_bytes": len(payload), "fcfg": fcfg, "detailed": detailed,
            "monitor": monitor}


def encode_wave_group(group: list[Frame], coding_structure: CodingStructure,
                      video_path: str, workdir: str, preset: Preset,
                      cfg_args: dict[str, dict], warp_filter_size: int = 8, seed: int = 0,
                      verbose: bool = True, rdoq: bool = True, tune: str = "mse",
                      profile: str = "ref", device: str | torch.device = "cuda") -> list[dict]:
    """Encode the frames of one GOP wave together on `device`: the
    per-frame prep (references, global translation, motion pretraining)
    and warm-up as encode_one_frame runs them, then the main phases as ONE
    batch with the frames as slots (their references stacked on the batch
    axis, slot i's noise from its own frame's generators), then the
    per-frame NN quantization, RDOQ, checkpoint and bitstream. A frame
    with a checkpoint in the workdir is finalized from it. Returns one
    result per frame of `group`, in its order.

    The frames of `group` share frame type and depth (the wave grouping of
    encode_video guarantees it), hence preset, operating point and size."""
    dev = resolve_device(device)
    results: dict[int, dict] = {}
    todo: list[tuple[Frame, dict]] = []
    for frame in group:
        fdata = load_frame_data_from_file(video_path, frame.display_order + frame.frame_offset)
        frame.data = fdata
        ckpt_path = os.path.join(workdir, f"{frame.display_order:04d}-frame_encoder.npz")
        if os.path.exists(ckpt_path):
            params, fcfg, nn_side_info = load_frame_encoder(ckpt_path)
            results[frame.display_order] = _finalize_frame(
                frame, coding_structure, params, fcfg, nn_side_info, fdata, workdir,
                video_path, verbose, profile=profile, lmbda=preset.lmbda, device=dev)
            continue
        prep = _prep_frame(frame, fdata, workdir, video_path, preset, cfg_args,
                           warp_filter_size, seed, tune, dev, verbose)
        if any(v is not None for v in prep["cr"].values()):
            raise ValueError("a wave group does not train common-randomness configs")
        todo.append((frame, prep))

    if todo:
        warmed = []
        for frame, prep in todo:
            if preset.warmup.phases:
                noise = TorchNoise(_frame_phase_generator(seed, frame.display_order, -1, dev))
                with prep["monitor"].timed("warmup"):
                    warmed.append(warmup_batched(
                        prep["candidates"], preset, prep["fcfg"], prep["target"],
                        noise_source=noise, refs=prep["refs"], monitor=prep["monitor"],
                        verbose=verbose))
            else:
                warmed.append(prep["candidates"][0])

        # The main phases: the frames are the batch slots. Display index and
        # reference ids are bitstream metadata, so the first frame's config
        # serves the compute of every slot.
        fcfg0, monitor = todo[0][1]["fcfg"], todo[0][1]["monitor"]
        params_b = stack_trees(warmed)
        tgts = [prep["target"] for _, prep in todo]
        targets_b = (tree_map(lambda *xs: torch.cat(xs), *tgts) if isinstance(tgts[0], dict)
                     else torch.cat(tgts))
        refs_b = None
        if fcfg0.frame_type != "I":
            refs_b = [torch.cat([prep["refs"][j] for _, prep in todo])
                      for j in range(len(fcfg0.index_references))]
        for idx, phase in enumerate(preset.training_phases):
            # slot i draws from the generator its frame gets on the serial
            # path, so batching does not change any frame's noise
            noise = SlotNoise([_frame_phase_generator(seed, frame.display_order, idx, dev)
                               for frame, _ in todo])
            t0 = time.time()
            with monitor.timed(f"wave_train_phase_{idx}"):
                params_b, _ = _batched_phase(params_b, targets_b, fcfg0, phase, monitor,
                                             verbose, noise_source=noise, refs_b=refs_b)
            if verbose:
                print(f"wave phase {idx} ({len(todo)} frames) done in "
                      f"{time.time() - t0:.1f}s", flush=True)

        for i, (frame, prep) in enumerate(todo):
            params, nn_side_info = _quantize_frame(
                tree_to_numpy(index_tree(params_b, i)), prep["fcfg"], preset, prep["target"],
                frame.data, prep["monitor"], verbose, dev, rdoq=rdoq, refs=prep["refs"])
            save_frame_encoder(os.path.join(
                workdir, f"{frame.display_order:04d}-frame_encoder.npz"),
                params, prep["fcfg"], nn_side_info)
            results[frame.display_order] = _finalize_frame(
                frame, coding_structure, params, prep["fcfg"], nn_side_info, frame.data,
                workdir, video_path, verbose, profile=profile, lmbda=preset.lmbda,
                monitor=prep["monitor"], device=dev)
    return [results[frame.display_order] for frame in group]


def frame_cfg_args(frame_type: str, depth: int) -> tuple[dict, dict]:
    """Per-depth operating points and schedule scaling (reference
    samples/encode.py:23-70): intra hop; P residue and motion mop; B mop at
    depth 1 and lop deeper, with budgets shrinking and λ growing by 1.5 a
    level."""
    if frame_type == "I":
        return {"residue": dict(intra_operating_points()["hop"])}, dict(
            start_lr=1e-2, n_itr=10000, n_itr_motion=0, lmbda_scale=1.0)
    if frame_type == "P":
        return ({"residue": dict(residue_operating_points()["mop"]),
                 "motion": dict(motion_operating_points()["mop"])},
                dict(start_lr=5e-3, n_itr=10000, n_itr_motion=3000, lmbda_scale=1.0))
    op = "mop" if depth == 1 else "lop"
    return ({"residue": dict(residue_operating_points()[op]),
             "motion": dict(motion_operating_points()[op])},
            dict(start_lr=1e-2, n_itr=max(10000 - 2000 * depth, 1000),
                 n_itr_motion=max(5000 - 1000 * depth, 1000),
                 lmbda_scale=1.5**depth))


def _frame_preset(frame: Frame, lmbda: float, itr_scale: float, *,
                  itr_floor: int = 2000) -> tuple[dict, Preset]:
    """The operating points and preset of one frame of encode_video: the
    iteration budget scaled by `itr_scale`, no lower than `itr_floor`
    (2000 in production; a short smoke schedule passes less)."""
    cfg_args, sched = frame_cfg_args(frame.frame_type, frame.depth)
    kw = dict(lmbda=lmbda * sched["lmbda_scale"], start_lr=sched["start_lr"],
              itr_main_training=max(int(sched["n_itr"] * itr_scale), itr_floor),
              itr_motion_pretrain=max(int(sched["n_itr_motion"] * itr_scale), 0))
    preset = (PresetIntra(**kw, itr_floor=itr_floor) if frame.frame_type == "I"
              else PresetInter(**kw))
    return cfg_args, preset


def encode_video(video_path: str, bitstream_path: str, workdir: str, *, n_frames: int,
                 intra_pos: list[int], p_pos: list[int], lmbda: float = 1e-3,
                 itr_scale: float = 1.0, seed: int = 0, verbose: bool = True,
                 waves: bool = False, itr_floor: int = 2000,
                 device: str | torch.device = "cuda") -> dict:
    """GOP driver on `device`: encode every frame in coding order
    (reference samples/encode.py) into one bitstream. `waves=True` groups
    the frames into dependency waves (parallel/gop.py) and encodes every
    same-(type, depth) group of a wave as one batch (encode_wave_group), so
    a hierarchical-B GOP trains its widest levels together. Returns the
    byte count and each frame's result in coding order."""
    from coolchic_tpu_torch.parallel.gop import gop_waves

    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    cs = CodingStructure(n_frames=n_frames, intra_pos=list(intra_pos), p_pos=list(p_pos))
    if verbose:
        print(cs.pretty_string(), flush=True)

    by_coding: dict[int, dict] = {}
    if waves:
        for wave in gop_waves(cs):
            groups: dict[tuple, list[Frame]] = {}
            for frame in wave:
                groups.setdefault((frame.frame_type, frame.depth), []).append(frame)
            for (ftype, depth), members in sorted(groups.items()):
                cfg_args, preset = _frame_preset(members[0], lmbda, itr_scale,
                                                 itr_floor=itr_floor)
                if verbose:
                    print(f"wave group ({ftype}, depth {depth}): " + ", ".join(
                        f"{f.frame_type}{f.display_order}" for f in members), flush=True)
                for frame, res in zip(members, encode_wave_group(
                        members, cs, video_path, workdir, preset, cfg_args, seed=seed,
                        verbose=verbose, device=dev)):
                    by_coding[frame.coding_order] = res
    else:
        for coding_idx in range(cs.get_max_coding_order() + 1):
            frame = cs.get_frame_from_coding_order(coding_idx)
            cfg_args, preset = _frame_preset(frame, lmbda, itr_scale, itr_floor=itr_floor)
            by_coding[coding_idx] = encode_one_frame(frame, cs, video_path, workdir, preset,
                                                     cfg_args, seed=seed, verbose=verbose,
                                                     device=dev)

    results = [by_coding[i] for i in sorted(by_coding)]
    payload = b"".join(r["payload"] for r in results)
    with open(bitstream_path, "wb") as f:
        f.write(payload)
    return {"n_bytes": len(payload), "results": results}
