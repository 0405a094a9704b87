"""One training phase over a batch of images (or warm-up candidates).

Each image owns its params, optimizer state and target, so G images train
as one batched program: a leading axis on every tensor. Per phase (the
port of coolchic_tpu/parallel/encode_batch.py:_batched_phase):

  SOAP seeding from the first gradient -> windows of freq_valid steps ->
  eval at the validation point -> per-image best snapshot -> per-image
  patience reload (when the lr is scheduled).

The host reads one [G] loss vector per window and nothing per step. The
mesh / shard_map branch of the JAX package is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.train import (
    EncoderMonitor,
    PhaseFns,
    cosine_lr,
    init_opt_state,
    linear_schedule,
    seed_opt_state,
)
from coolchic_tpu_torch.train.params import tree_leaves, tree_unflatten


def _select(mask_b: torch.Tensor, new: list, old: list) -> list:
    """Per-image masked update of leaf lists (mask over the batch axis)."""
    return [torch.where(mask_b.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, old)]


def _batched_phase(params_b: dict, targets_b, fcfg: FrameConfig, phase: TrainerPhase,
                   monitor: EncoderMonitor, verbose: bool, *, noise_source,
                   seed_soap: bool = True, cr: Optional[dict] = None,
                   refs_b: Optional[list] = None) -> tuple[dict, torch.Tensor]:
    """One training phase over the batch; returns (best params per image,
    best loss [G]).

    params_b: frame params, every leaf [G, ...]; targets_b: [G, C, H, W]
    (or a dict of planes). Every slot trains at the phase's λ and noise
    levels (the JAX package's per-slot λ and noise rows serve its batched
    multi-image encode, not ported yet). `noise_source` draws the noise
    (train.TorchNoise, or a test's injected draws). `seed_soap=False` skips
    the SOAP seeding gradient, as the JAX warm-up does. `cr`: the
    common-randomness grids every slot shares (models/frame.py:
    frame_cr_grids), or None. `refs_b`: a P/B frame's decoded references,
    one [G, 3, H, W] tensor each, riding the batch axis with the targets."""
    like = params_b
    leaves = [x.detach() for x in tree_leaves(params_b)]
    dev = leaves[0].device
    n = leaves[0].shape[0]
    lmbda_b = torch.full((n,), phase.lmbda, dtype=torch.float32, device=dev)
    noise_b = np.tile(np.asarray(phase.noise_parameter, np.float32), (n, 1))

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
