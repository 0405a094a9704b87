"""Warm-up: a candidate tournament over differently-seeded initializations.

Each phase briefly trains the surviving candidates, ranks them by loss and
prunes to the next phase's candidate count; the winner seeds the main
training. The candidates are the batch of the batched phase
(parallel/encode_batch.py), chunked to a pixel x candidate budget.

The JAX package runs this batched tournament on accelerators and a serial
one (one candidate at a time) on the CPU (coolchic_tpu/train/video.py:
151-153); both keep the survivors by loss. The port uses the batched
tournament on every device.

Reference parity: coolchic/training/warmup.py through
coolchic_tpu/train/warmup.py:warmup_batched.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.parallel.encode_batch import _batched_phase
from coolchic_tpu_torch.train.params import tree_map
from coolchic_tpu_torch.train.presets import Preset, TrainerPhase
from coolchic_tpu_torch.train.train import EncoderMonitor, index_tree, stack_trees


def _train_phase_batched(stacked: dict, ph: TrainerPhase, fcfg: FrameConfig, target,
                         noise_source, monitor: EncoderMonitor,
                         cr: Optional[dict] = None, refs: Optional[list] = None
                         ) -> tuple[dict, torch.Tensor]:
    """One warm-up phase for a stack of candidates; returns
    (best_params_stacked, best_losses [n]). As in the JAX package, the
    lr, temperature and noise hold their starting values and the SOAP
    bases are not seeded."""
    held = dataclasses.replace(
        ph, schedule_lr=False,
        softround_temperature=(ph.softround_temperature[0],) * 2,
        noise_parameter=(ph.noise_parameter[0],) * 2)
    n = stacked["global_flow_1"].shape[0]
    targets = tree_map(lambda t: t.expand(n, *t.shape[1:]), target) \
        if isinstance(target, dict) else target.expand(n, *target.shape[1:])
    refs_b = None if refs is None else [r.expand(n, *r.shape[1:]) for r in refs]
    return _batched_phase(stacked, targets, fcfg, held, monitor, False,
                          noise_source=noise_source, seed_soap=False, cr=cr, refs_b=refs_b)


def candidate_chunk_size(n_pixels: int, n_candidates: int) -> int:
    """How many candidates train together in one batched program. The
    COOLCHIC_WARMUP_BATCH_PX budget (pixels x candidates) bounds activation
    memory; equal-size chunks keep each chunk inside the budget."""
    budget = int(os.environ.get("COOLCHIC_WARMUP_BATCH_PX", 1_500_000))
    per = max(1, budget // max(n_pixels, 1))
    return max(1, min(per, n_candidates))


def warmup_batched(candidates: list[dict], preset: Preset, fcfg: FrameConfig, target, *,
                   noise_source, cr: Optional[dict] = None, refs: Optional[list] = None,
                   monitor: Optional[EncoderMonitor] = None,
                   verbose: bool = False) -> dict:
    """All surviving candidates advance together through each warm-up phase
    (chunked to the activation-memory budget); returns the winner's params
    (no batch axis). `target`: one image's [1, C, H, W] (or planes); `refs`:
    a P/B frame's [1, 3, H, W] references, broadcast over the candidates as
    the target is; `cr`: the frame's common-randomness grids, carried into
    every phase as the JAX warm-up carries them."""
    monitor = monitor or EncoderMonitor()
    n = len(candidates)
    stacked = stack_trees(candidates)
    h, w = fcfg.cc_cfgs["residue"].img_size

    for idx_phase, wu_phase in enumerate(preset.warmup.phases):
        ph = wu_phase.training_phase
        keep = wu_phase.candidates
        if keep < n:
            stacked = tree_map(lambda x: x[:keep], stacked)
            n = keep

        chunk = candidate_chunk_size(h * w, n)
        parts_params, parts_loss = [], []
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            sub = tree_map(lambda x: x[c0:c1], stacked)
            bp, bl = _train_phase_batched(sub, ph, fcfg, target, noise_source, monitor,
                                          cr=cr, refs=refs)
            parts_params.append(bp)
            parts_loss.append(bl)
        stacked = tree_map(lambda *xs: torch.cat(xs), *parts_params)
        best_loss = torch.cat(parts_loss)

        losses = [float(v) for v in best_loss.cpu()]
        rank = sorted(range(n), key=lambda i: losses[i])
        order = torch.as_tensor(rank, device=best_loss.device)
        stacked = tree_map(lambda x: x[order], stacked)
        if verbose:
            ranked = ", ".join(f"{losses[i] * 1e3:.4f}" for i in rank)
            chunk_note = f" (chunks of {chunk})" if chunk < n else ""
            print(f"  warmup phase {idx_phase}: candidate losses (1e-3) "
                  f"[{ranked}]{chunk_note}", flush=True)

    return index_tree(stacked, 0)
