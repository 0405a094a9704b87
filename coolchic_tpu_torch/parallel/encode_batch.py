"""Batch image encoding: many images (or warm-up candidates, or the frames
of a GOP wave) as one batched training program.

Each image owns its params, optimizer state, target and rate point, so G
images train as one batched program: a leading axis on every tensor. Per
phase (the port of coolchic_tpu/parallel/encode_batch.py:_batched_phase):

  SOAP seeding from the first gradient -> windows of freq_valid steps ->
  eval at the validation point -> per-image best snapshot -> per-image
  patience reload (when the lr is scheduled).

The host reads one [G] loss vector per window and nothing per step.
encode_images_batched encodes N same-sized I images this way: a
single-stage warm-up whose candidates train batched over all images, each
image keeping its best candidate, the main phases batched, then NN
quantization, RDOQ and the bitstream write per image. A dataset sweep
(images x rate points) runs as mixed-λ batches. The mesh / shard_map
branch of the JAX package is not ported.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.encode import encode_frame
from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.core.device import resolve_device
from coolchic_tpu_torch.io.framedata import FrameData
from coolchic_tpu_torch.models.frame import FrameConfig, frame_encoder_init
from coolchic_tpu_torch.models.params import tree_from_numpy, tree_to_numpy
from coolchic_tpu_torch.nnquant.quantize import quantize_coolchic
from coolchic_tpu_torch.nnquant.rdoq import rdoq_coolchic
from coolchic_tpu_torch.train.encode import _target_from_frame, img_min_max
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase
from coolchic_tpu_torch.train.train import (
    EncoderMonitor,
    PhaseFns,
    SlotNoise,
    _frame_phase_generator,
    cosine_lr,
    index_tree,
    init_opt_state,
    linear_schedule,
    seed_opt_state,
    stack_trees,
    test,
)
from coolchic_tpu_torch.train.params import tree_leaves, tree_map, tree_unflatten
from coolchic_tpu_torch.utils.codingstructure import CodingStructure


def _select(mask_b: torch.Tensor, new: list, old: list) -> list:
    """Per-image masked update of leaf lists (mask over the batch axis)."""
    return [torch.where(mask_b.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, old)]


def _batched_phase(params_b: dict, targets_b, fcfg: FrameConfig, phase: TrainerPhase,
                   monitor: EncoderMonitor, verbose: bool, *, noise_source,
                   seed_soap: bool = True, cr: Optional[dict] = None,
                   refs_b: Optional[list] = None, lmbda_b=None,
                   noise_b=None) -> tuple[dict, torch.Tensor]:
    """One training phase over the batch; returns (best params per image,
    best loss [G]).

    params_b: frame params, every leaf [G, ...]; targets_b: [G, C, H, W]
    (or a dict of planes). `lmbda_b` ([G]) gives each slot its own rate
    point and `noise_b` ([G, 2] start/end rows) its own noise schedule;
    each defaults to the phase's. `noise_source` draws the noise
    (train.TorchNoise for one stream, train.SlotNoise for one stream per
    slot, or a test's injected draws). `seed_soap=False` skips the SOAP
    seeding gradient, as the JAX warm-up does. `cr`: the common-randomness
    grids every slot shares (models/frame.py:frame_cr_grids), or None.
    `refs_b`: a P/B frame's decoded references, one [G, 3, H, W] tensor
    each, riding the batch axis with the targets."""
    like = params_b
    leaves = [x.detach() for x in tree_leaves(params_b)]
    dev = leaves[0].device
    n = leaves[0].shape[0]
    if lmbda_b is None:
        lmbda_b = torch.full((n,), phase.lmbda, dtype=torch.float32, device=dev)
    else:
        lmbda_b = torch.as_tensor(np.asarray(lmbda_b, np.float32).reshape(n), device=dev)
    if noise_b is None:
        noise_b = np.tile(np.asarray(phase.noise_parameter, np.float32), (n, 1))
    else:
        noise_b = np.asarray(noise_b, np.float32).reshape(n, 2)

    fns = PhaseFns(fcfg, like, phase.quantizer_noise_type, phase.quantizer_type,
                   phase.dist_weight, tuple(phase.betas_model), tuple(phase.betas_latent),
                   phase.precondition_frequency_model, cr=cr)
    opt = init_opt_state(leaves, fns.groups, fns.hp_weight, fns.hp_latent)

    def draw(kind, noise_now: np.ndarray):
        # one host-to-card copy of the [G] noise levels per window, not per step
        level = torch.as_tensor(noise_now, device=dev)
        return lambda: noise_source(kind, fcfg, n, phase.quantizer_noise_type, level,
                                    fns.need_noise)

    if seed_soap:
        # Reference SOAP first-step parity: each slot's WEIGHT-leaf
        # eigenbases seed from its own first gradient (one extra gradient;
        # only the NN-weight gradients reach the host).
        temp0 = linear_schedule(phase.softround_temperature, 0, phase.max_itr)
        grads = fns.grads(leaves, draw("seed", noise_b[:, 0])(), temp0, targets_b,
                          lmbda_b, refs_b)
        opt = seed_opt_state(opt, grads, fns.groups, fns.hp_weight)

    best_loss = fns.eval(leaves, targets_b, lmbda_b, refs_b).loss
    best = [x.clone() for x in leaves]

    n_windows = math.ceil(phase.max_itr / phase.freq_valid)
    t_max = phase.max_itr / phase.freq_valid
    patience_windows = max(phase.patience // phase.freq_valid, 1)
    since_record = np.zeros(n, dtype=np.int64)

    cnt = 0
    for w_idx in range(n_windows):
        if phase.schedule_lr and (since_record > patience_windows).any():
            reload = since_record > patience_windows
            leaves = _select(torch.as_tensor(reload, device=dev), best, leaves)
            since_record[reload] = 0

        lr = cosine_lr(phase.lr, w_idx, t_max) if phase.schedule_lr else phase.lr
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        temp = linear_schedule(phase.softround_temperature, cnt, phase.max_itr)
        # per-slot linear schedule (same math as linear_schedule, in f32)
        noise = noise_b[:, 0] + cnt * (noise_b[:, 1] - noise_b[:, 0]) / phase.max_itr
        n_steps = min(phase.freq_valid, phase.max_itr - cnt)

        leaves, opt = fns.window(leaves, opt, draw("step", noise), n_steps, temp, lr_t,
                                 targets_b, lmbda_b, refs_b)
        cnt += n_steps
        monitor.iterations_counter += n_steps * n

        lo = fns.eval(leaves, targets_b, lmbda_b, refs_b)
        improved = lo.loss < best_loss
        best = _select(improved, leaves, best)
        best_loss = torch.where(improved, lo.loss, best_loss)
        imp = improved.cpu().numpy()   # the host sync of the window
        since_record = np.where(imp, 0, since_record + 1)
        if verbose:
            ls = " ".join(f"{v * 1e3:7.4f}" for v in lo.loss.cpu().numpy())
            print(f"  itr {cnt:>6} losses(1e-3) [{ls}] lr {lr:.5f}", flush=True)

    return tree_unflatten(like, best), best_loss


def _batch_generators(seed: int, n: int, phase_idx: int, device: torch.device) -> list:
    """One generator per slot, seeded from (seed, slot, phase): slot i of a
    batch trains alike whatever the other slots hold. phase_idx: the main
    phases >= 0, the candidates' init -2, warm-up candidate c -5 - c."""
    return [_frame_phase_generator(seed, i, phase_idx, device) for i in range(n)]


def encode_images_batched(frames: Sequence[FrameData], cfgs: dict[str, CoolChicConfig],
                          preset: Preset, out_paths: Sequence[str], *, seed: int = 0,
                          verbose: bool = True, rdoq: bool = True, profile: str = "ref",
                          on_image=None, lmbdas: Optional[Sequence[float]] = None,
                          monitor: Optional[EncoderMonitor] = None,
                          device: str | torch.device = "cuda") -> list[dict]:
    """Encode N same-sized I frames as one batch on `device` and write one
    bitstream per image; returns a result dict per image (psnr_db, loss,
    rate_bpp, latent_rate_bpp, n_bytes, n_pixels).

    `lmbdas` (optional, one per image) gives each slot its own rate point,
    so a whole RD sweep (images x λ) runs as mixed batches; the λ-derived
    warm-up noise follows each slot's λ (Preset.warmup_noise_parameter).
    `on_image(i, result)` is called as each image's file is written.
    `monitor` (optional) collects seconds per stage and the peak memory.
    The port of coolchic_tpu/parallel/encode_batch.py:encode_images_batched,
    less its mesh."""
    dev = resolve_device(device)
    n = len(frames)
    if len(out_paths) != n:
        raise ValueError(f"{len(out_paths)} output paths for {n} images")
    lmbdas_f = [float(x) for x in lmbdas] if lmbdas is not None else [None] * n
    if len(lmbdas_f) != n:
        raise ValueError(f"{len(lmbdas_f)} rate points for {n} images")
    f0 = frames[0]
    for f in frames:
        if (f.img_size, f.frame_data_type, f.bitdepth) != (
                f0.img_size, f0.frame_data_type, f0.bitdepth):
            raise ValueError("a batched encode needs images of one size, type and bitdepth")
    fcfg = FrameConfig(coolchic_cfg=cfgs, frame_type="I", frame_data_type=f0.frame_data_type,
                       bitdepth=f0.bitdepth)
    if any(c.flag_common_randomness for c in cfgs.values()):
        raise ValueError("the batched encode does not support common randomness")
    tgts = [_target_from_frame(f, dev) for f in frames]
    targets_b = (tree_map(lambda *xs: torch.cat(xs), *tgts) if isinstance(tgts[0], dict)
                 else torch.cat(tgts))
    monitor = monitor or EncoderMonitor(device=dev)
    t_start = time.time()

    lmbda_b = lmbdas_f if lmbdas is not None else None
    # Per-slot λ-derived warm-up noise (reference training/presets.py:311):
    # in a mixed-λ batch every slot warms up at its own λ's noise level.
    wu_noise_b = None
    if lmbdas is not None:
        rows = [preset.warmup_noise_parameter(lam) for lam in lmbdas_f]
        if all(r is not None for r in rows):
            wu_noise_b = np.asarray(rows, np.float32)

    # --- Warm-up: each candidate trains batched over all images; each
    # image keeps its best candidate. (The reference's multi-stage pruning
    # is a per-image tournament; over a batch the single-stage argmin keeps
    # the same winners at a fraction of the orchestration.)
    init_gens = _batch_generators(seed, n, -2, dev)

    def init_batch() -> dict:
        return stack_trees([frame_encoder_init(g, fcfg, img_min_max(f), device=dev)
                            for g, f in zip(init_gens, frames)])

    n_candidates = preset.warmup.phases[0].candidates if preset.warmup.phases else 1
    if preset.warmup.phases and n_candidates > 1:
        wu_phase = preset.warmup.phases[0].training_phase
        best, best_loss = None, None
        with monitor.timed("warmup"):
            for c in range(n_candidates):
                params_b, loss_b = _batched_phase(
                    init_batch(), targets_b, fcfg, wu_phase, monitor, False,
                    noise_source=SlotNoise(_batch_generators(seed, n, -5 - c, dev)),
                    lmbda_b=lmbda_b, noise_b=wu_noise_b)
                if best is None:
                    best, best_loss = params_b, loss_b
                else:
                    better = loss_b < best_loss
                    best = tree_unflatten(best, _select(better, tree_leaves(params_b),
                                                        tree_leaves(best)))
                    best_loss = torch.where(better, loss_b, best_loss)
                if verbose:
                    ls = " ".join(f"{v * 1e3:.4f}" for v in loss_b.cpu().numpy())
                    print(f"warm-up candidate {c}: losses(1e-3) [{ls}]", flush=True)
        params_b = best
    else:
        params_b = init_batch()

    # --- Main phases, batched.
    for idx, phase in enumerate(preset.training_phases):
        t0 = time.time()
        with monitor.timed(f"train_phase_{idx}"):
            params_b, _ = _batched_phase(
                params_b, targets_b, fcfg, phase, monitor, verbose,
                noise_source=SlotNoise(_batch_generators(seed, n, idx, dev)),
                lmbda_b=lmbda_b)
        if verbose:
            print(f"phase {idx} done in {time.time() - t0:.1f}s", flush=True)

    # --- Per image: NN quantization, RDOQ, bitstream write, logs.
    from coolchic_tpu_torch.train.video import _grid_scorer   # video imports this module

    phase0 = preset.training_phases[-1]
    n_pixels = f0.n_pixels
    cs = CodingStructure(n_frames=1, intra_pos=[0])
    results = []
    for i in range(n):
        if verbose:
            print(f"image {i}: quantize+rdoq tail...", flush=True)
        params = tree_to_numpy(index_tree(params_b, i))
        target = tgts[i]
        lam_i = lmbdas_f[i] if lmbdas_f[i] is not None else phase0.lmbda
        nn_side_info = {}
        for cc_name in fcfg.cc_cfgs:
            score = _grid_scorer(params, fcfg, cc_name, target, lam_i, phase0.dist_weight,
                                 dev)
            with monitor.timed("nn_quantize"):
                q_params, q_shift, expgol, _ = quantize_coolchic(
                    params[cc_name], fcfg.cc_cfgs[cc_name], score, lam_i, n_pixels,
                    verbose=False)
            if rdoq:
                # the JAX batched encode refines synthesis and upsampling
                # against an RGB target only (a yuv420 batch: ARM and IFCE)
                rdoq_target = None if isinstance(target, dict) else np.asarray(frames[i].data)
                with monitor.timed("rdoq"):
                    q_params = rdoq_coolchic(q_params, fcfg.cc_cfgs[cc_name], q_shift,
                                             expgol, lam_i, target=rdoq_target,
                                             frame_type="I", verbose=verbose, device=dev)
            params = {**params, cc_name: q_params}
            nn_side_info[cc_name] = (q_shift, expgol)

        logs = test(tree_from_numpy(params, dev), fcfg, target,
                    dist_weight=phase0.dist_weight, lmbda=lam_i)
        with monitor.timed("bitstream_write"):
            payload = encode_frame(params, fcfg, cs, nn_side_info, is_first_frame=True,
                                   profile=profile)
            with open(out_paths[i], "wb") as f:
                f.write(payload)
        results.append({
            "psnr_db": logs.psnr_db,
            "loss": logs.loss,
            "rate_bpp": 8 * len(payload) / n_pixels,
            "latent_rate_bpp": logs.total_rate_latent_bpp,
            "n_bytes": len(payload),
            "n_pixels": n_pixels,
        })
        if on_image is not None:
            on_image(i, results[-1])
        if verbose:
            print(f"image {i}: psnr {logs.psnr_db:.3f} dB, "
                  f"{results[-1]['rate_bpp']:.4f} bpp -> {out_paths[i]}", flush=True)

    if verbose:
        print(f"batch of {n} images done in {time.time() - t_start:.1f}s "
              f"({monitor.iterations_counter} candidate-iterations)\n" + monitor.report(),
              flush=True)
    return results
