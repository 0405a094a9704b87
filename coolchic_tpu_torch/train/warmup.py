"""Warm-up: a candidate tournament over differently-seeded initializations.

Each phase briefly trains the surviving candidates, ranks them by loss and
prunes to the next phase's candidate count; the winner seeds the main
training. The candidates are the batch of the batched phase
(parallel/encode_batch.py), chunked to a pixel x candidate budget.

The JAX package runs this batched tournament on accelerators and a serial
one (one candidate at a time, `warmup`) on the CPU and for a spatially
sharded frame (coolchic_tpu/train/video.py:150-156); both keep the
survivors by loss. The port runs the batched tournament on every device,
and the serial one for a sharded frame, each candidate training sharded.

Reference parity: coolchic/training/warmup.py through
coolchic_tpu/train/warmup.py:warmup_batched and warmup.
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
from coolchic_tpu_torch.train.train import (
    EncoderMonitor,
    index_tree,
    stack_trees,
    test,
    train,
)


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


def warmup(candidates: list[dict], preset: Preset, fcfg: FrameConfig, target, *,
           noise_source, cr: Optional[dict] = None, refs: Optional[list] = None,
           monitor: Optional[EncoderMonitor] = None, verbose: bool = False,
           spatial_mesh=None) -> dict:
    """The serial tournament (coolchic_tpu/train/warmup.py:warmup): each
    phase trains its surviving candidates one after another with the serial
    trainer (train.train: SOAP seeding, the phase's schedules, patience),
    scores each by its eval loss and keeps the best `candidates` for the
    next phase; returns the winner's params (no batch axis).
    `noise_source` serves every candidate in turn; `spatial_mesh` shards
    each candidate's training (parallel/spatial.py)."""
    monitor = monitor or EncoderMonitor()
    ranked = [{"id": i, "params": p, "loss": None} for i, p in enumerate(candidates)]
    for idx_phase, wu_phase in enumerate(preset.warmup.phases):
        ph = wu_phase.training_phase
        ranked = ranked[: wu_phase.candidates]
        for cand in ranked:
            cand["params"] = train(cand["params"], fcfg, target, ph,
                                   noise_source=noise_source, cr=cr, refs=refs,
                                   monitor=monitor, spatial_mesh=spatial_mesh)
            logs = test(cand["params"], fcfg, target, cr=cr, dist_weight=ph.dist_weight,
                        lmbda=ph.lmbda, refs=refs)
            cand["loss"] = logs.loss
            if verbose:
                print(f"  warmup phase {idx_phase} candidate {cand['id']}: "
                      f"loss {logs.loss * 1e3:.4f} psnr {logs.psnr_db:.3f} "
                      f"bpp {logs.total_rate_latent_bpp:.4f}", flush=True)
        ranked.sort(key=lambda c: c["loss"])
    return ranked[0]["params"]
