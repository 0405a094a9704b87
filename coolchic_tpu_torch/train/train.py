"""The overfitting training step (the "encoder"), its schedules and its
bookkeeping.

One step = forward with the drawn noise, autograd backward, global-norm clip
of the weight group at 0.1, one SOAP step per leaf (network weights) or
Adam (latents), and the QR eigenbasis refresh on every
`precondition_frequency`-th step of a validation window. Everything is
batched over a leading axis of G images (parallel/encode_batch.py drives
the windows); the host reads losses only at the validation points.

The serial trainer `train()` runs one phase of one image (G = 1) with the
JAX package's patience rule (stop, or reload the best model when the lr is
scheduled); the encoder uses it for common-randomness configs, as the JAX
package does (coolchic_tpu/train/video.py:161-198).

Reference parity: coolchic/training/train.py (per-group optimizers, cosine
LR stepping once per validation, linear temperature & noise schedules,
patience that reloads the best model when schedule_lr is on), through
coolchic_tpu/train/train.py:_make_fns_impl and train, whose lax.scan
windows become a Python loop of steps here. The spatial-mesh branches are
not ported.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import torch

from coolchic_tpu_torch.core.quantizer import sample_noise
from coolchic_tpu_torch.models.frame import FrameConfig, frame_encoder_forward
from coolchic_tpu_torch.train.loss import LossOutput, dist_to_db, loss_function
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.params import (
    FROZEN,
    WEIGHT,
    group_tree,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from coolchic_tpu_torch.train.soap import (
    SoapHyperParams,
    soap_init_from_grad_leaf,
    soap_init_leaf,
    soap_step_leaf,
)
from coolchic_tpu_torch.train.wasserstein import make_wasserstein_fn

ETA_MIN = 1e-5


def linear_schedule(initial_final: tuple[float, float], cur_itr: float, max_itr: float) -> float:
    initial, final = initial_final
    return cur_itr * (final - initial) / max_itr + initial


def cosine_lr(lr0: float, t: int, t_max: float) -> float:
    if t_max <= 0:
        return lr0
    return ETA_MIN + (lr0 - ETA_MIN) * (1 + math.cos(math.pi * t / t_max)) / 2


class EncoderLogs(NamedTuple):
    loss: float
    dist: float
    psnr_db: float
    total_rate_latent_bpp: float
    rate_bpp: float


@dataclass
class EncoderMonitor:
    """Per-encode bookkeeping (reference utils/misc.py training timing
    prints): iteration counts, wall-clock per pipeline stage, and the card's
    peak allocated memory. A stage's time ends with a synchronize of the
    card, so it holds the device work it queued. total_training_time_sec
    sums the serial trainer's phases, as in the JAX package."""

    total_training_time_sec: float = 0.0
    iterations_counter: int = 0
    phase_time_sec: dict = field(default_factory=dict)
    peak_device_bytes: int = 0
    device: Optional[torch.device] = None

    @contextmanager
    def timed(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.time() - t0
            self.phase_time_sec[name] = self.phase_time_sec.get(name, 0.0) + dt
            self.sample_device_memory()

    def sample_device_memory(self):
        if self.device is not None and self.device.type == "cuda":
            self.peak_device_bytes = max(self.peak_device_bytes,
                                         torch.cuda.max_memory_allocated(self.device))

    def report(self) -> str:
        total = sum(self.phase_time_sec.values()) or 1.0
        lines = [f"  {k:<18} {v:8.1f}s ({100 * v / total:4.1f}%)"
                 for k, v in self.phase_time_sec.items()]
        if self.peak_device_bytes:
            lines.append(f"  peak device mem    {self.peak_device_bytes / 2**20:.0f} MiB")
        lines.append(f"  iterations         {self.iterations_counter}")
        return "\n".join(lines)


class TorchNoise:
    """The trainer's default noise: one draw per latent grid per step, from
    a torch.Generator on the card. The streams differ from the JAX
    package's PRNG (jax.random cannot be reproduced in torch); the
    distributions are the same. Called with kind "seed" for the SOAP
    seeding gradient and "step" for every training step, in order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, kind: str, fcfg: FrameConfig, G: int, noise_type: str,
                 noise_parameter: torch.Tensor, need: bool) -> Optional[dict]:
        if not need:
            return None
        param = noise_parameter.reshape(G, 1, 1)
        return {name: [sample_noise((G, *s), noise_type, param, generator=self.generator,
                                    device=param.device)
                       for s in cfg.size_per_latent]
                for name, cfg in fcfg.cc_cfgs.items()}


class SlotNoise:
    """One noise stream per batch slot: slot i draws its [1, ...] share of
    every grid from its own torch.Generator, and the slots' draws are
    concatenated. Slot i therefore gets exactly the draws that
    TorchNoise(generator i) gives a batch of one, the SOAP-seeding draw
    included, whatever the other slots are (the JAX package's per-slot
    keys, keys_b of parallel/encode_batch.py:_batched_phase)."""

    def __init__(self, generators: list):
        self.generators = list(generators)

    def __call__(self, kind: str, fcfg: FrameConfig, G: int, noise_type: str,
                 noise_parameter: torch.Tensor, need: bool) -> Optional[dict]:
        if G != len(self.generators):
            raise ValueError(f"{len(self.generators)} generators for a batch of {G}")
        if not need:
            return None
        param = noise_parameter.reshape(G, 1, 1)
        return {name: [torch.cat([sample_noise((1, *s), noise_type, param[i:i + 1],
                                               generator=g, device=param.device)
                                  for i, g in enumerate(self.generators)])
                       for s in cfg.size_per_latent]
                for name, cfg in fcfg.cc_cfgs.items()}


def _frame_phase_generator(seed: int, display_order: int, phase_idx: int,
                           device: torch.device) -> torch.Generator:
    """Per-(frame, phase) generator, independent of batch composition: the
    main phases use phase_idx >= 0, the warm-up -1, the candidate init -2,
    the motion pretraining's init -3 and its training noise -4. The
    batched multi-image encode seeds slot i as display order i."""
    g = torch.Generator(device=device)
    g.manual_seed((seed + 1000 * display_order) * 100_003 + 7919 + phase_idx)
    return g


class PhaseFns:
    """The step, gradient and eval of one phase configuration (the port of
    coolchic_tpu/train/train.py:_make_fns_impl). Parameters travel as the
    flattened leaf list of a batched frame-params tree shaped like `like`."""

    def __init__(self, fcfg: FrameConfig, like: dict, quantizer_noise_type: str,
                 quantizer_type: str, dist_weight: Dict[str, float],
                 betas_model: tuple, betas_latent: tuple,
                 precondition_frequency_model: int, cr: Optional[dict] = None):
        self.fcfg = fcfg
        self.cr = cr
        self._wd = None   # (target, its Wasserstein fn): target features once
        self.like = like
        self.groups = group_tree(like)
        self.quantizer_noise_type = quantizer_noise_type
        self.quantizer_type = quantizer_type
        self.dist_weight = dict(dist_weight)
        self.hp_weight = SoapHyperParams(
            b1=betas_model[0], b2=betas_model[1], weight_decay=0.01,
            precondition_frequency=precondition_frequency_model, max_precond_dim=256)
        self.hp_latent = SoapHyperParams(
            b1=betas_latent[0], b2=betas_latent[1], weight_decay=0.0,
            precondition_frequency=1, max_precond_dim=0)
        self.pf = max(precondition_frequency_model, 1)
        self.need_noise = (quantizer_type in ("none", "softround")
                           and quantizer_noise_type != "none")

    def wasserstein_fn(self, target):
        """The Wasserstein term's fn for `target`, its VGG features computed
        on the first call with that target (one image's, when the batch is a
        broadcast of it: the warm-up and the NN-quantization trials expand
        one target anew for each batch); None when the phase has no such
        term. The cache holds the target, so a tensor at the same address
        and shape shares its storage."""
        if "wasserstein" not in self.dist_weight:
            return None
        one = target[:1] if target.shape[0] > 1 and target.stride(0) == 0 else target
        if (self._wd is None or self._wd[0].data_ptr() != one.data_ptr()
                or self._wd[0].shape != one.shape):
            self._wd = (one, make_wasserstein_fn(one))
        return self._wd[1]

    def loss(self, leaves: list, noise, temp, target, lmbda, refs=None) -> LossOutput:
        out = frame_encoder_forward(
            tree_unflatten(self.like, leaves), self.fcfg, reference_frames=refs, noise=noise,
            quantizer_type=self.quantizer_type, soft_round_temperature=temp,
            training=True, cr=self.cr)
        return loss_function(out.decoded_image, out.rate, target, self.dist_weight, lmbda,
                             wasserstein_fn=self.wasserstein_fn(target))

    def grads(self, leaves: list, noise, temp, target, lmbda, refs=None) -> list:
        """d(sum of the images' losses)/d(leaf) per trainable leaf (zeros
        for a leaf the loss does not reach), None for frozen leaves. The
        images are independent, so each slot gets its own gradient. `refs`:
        a P/B frame's references, one [G, 3, H, W] tensor each (every
        method takes them)."""
        with torch.enable_grad():
            req = [x.detach().requires_grad_(grp != FROZEN)
                   for x, grp in zip(leaves, self.groups)]
            train = [x for x in req if x.requires_grad]
            lo = self.loss(req, noise, temp, target, lmbda, refs)
            gs = iter(torch.autograd.grad(lo.loss.sum(), train, allow_unused=True))
        out = []
        for x in req:
            if not x.requires_grad:
                out.append(None)
                continue
            g = next(gs)
            out.append(torch.zeros_like(x) if g is None else g)
        return out

    def step(self, leaves: list, states: list, noise, temp, lr: torch.Tensor,
             target, lmbda, refs=None, *, refresh: bool) -> tuple[list, list]:
        grads = self.grads(leaves, noise, temp, target, lmbda, refs)
        # Global-norm clip of the WEIGHT group at 0.1, per image
        # (reference train.py:228).
        sq = sum(torch.square(g).flatten(1).sum(dim=1)
                 for g, grp in zip(grads, self.groups) if grp == WEIGHT)
        norm = torch.sqrt(sq)
        clip = torch.minimum(torch.ones_like(norm), 0.1 / (norm + 1e-6))
        new_p, new_s = [], []
        for p, g, s, grp in zip(leaves, grads, states, self.groups):
            if grp == FROZEN or s is None:
                new_p.append(p)
                new_s.append(s)
                continue
            if grp == WEIGHT:
                g = g * clip.reshape((-1,) + (1,) * (g.dim() - 1))
                p2, s2 = soap_step_leaf(g, s, p, lr, self.hp_weight, refresh=refresh)
            else:
                p2, s2 = soap_step_leaf(g, s, p, lr, self.hp_latent, refresh=False)
            new_p.append(p2.detach())
            new_s.append(s2)
        return new_p, new_s

    def window(self, leaves: list, states: list, draw, n_steps: int, temp,
               lr: torch.Tensor, target, lmbda, refs=None) -> tuple[list, list]:
        """n_steps training steps (train.py:train_window of the JAX
        package): (pf - 1) plain steps then one eigenbasis-refresh step,
        from the window's start; a remainder of fewer than pf steps has no
        refresh. draw() gives each step's noise."""
        for s in range(n_steps):
            leaves, states = self.step(leaves, states, draw(), temp, lr, target, lmbda, refs,
                                       refresh=(s + 1) % self.pf == 0)
        return leaves, states

    def eval(self, leaves: list, target, lmbda, refs=None) -> LossOutput:
        """The decoder's view (hardround latents, bitdepth-rounded image)."""
        with torch.no_grad():
            out = frame_encoder_forward(tree_unflatten(self.like, leaves), self.fcfg,
                                        reference_frames=refs, training=False, cr=self.cr)
            return loss_function(out.decoded_image, out.rate, target, self.dist_weight,
                                 lmbda, wasserstein_fn=self.wasserstein_fn(target))


def init_opt_state(leaves: list, groups: list, hp_weight: SoapHyperParams,
                   hp_latent: SoapHyperParams) -> list:
    return [None if grp == FROZEN else
            soap_init_leaf(p, hp_weight if grp == WEIGHT else hp_latent)
            for p, grp in zip(leaves, groups)]


def seed_opt_state(states: list, grads: list, groups: list,
                   hp_weight: SoapHyperParams) -> list:
    """Reference SOAP first-step semantics (training/soap.py:163-182): seed
    each WEIGHT leaf's GG with its first gradient and set Q to the eigh
    eigenbasis; no parameter update. The eigh runs on the host
    (soap_init_from_grad_leaf); only the small weight-leaf gradients are
    fetched -- latent gradients never leave the device."""
    return [soap_init_from_grad_leaf(g, s, hp_weight) if grp == WEIGHT and s is not None
            else s for s, g, grp in zip(states, grads, groups)]


def logs_from_loss(lo: LossOutput, i: int = 0) -> EncoderLogs:
    """Host logs of image i of a batched LossOutput."""
    v = {k: float(getattr(lo, k)[i]) for k in LossOutput._fields}
    return EncoderLogs(loss=v["loss"], dist=v["dist"], psnr_db=dist_to_db(v["mse"]),
                       total_rate_latent_bpp=v["total_rate_latent_bpp"],
                       rate_bpp=v["rate_bpp"])


def test(params: dict, fcfg: FrameConfig, target, cr: Optional[dict] = None,
         dist_weight: Optional[Dict[str, float]] = None, lmbda: float = 1e-3,
         refs: Optional[list] = None) -> EncoderLogs:
    """Eval logs of one image's params (no batch axis) against its
    [1, C, H, W] target (and a P/B frame's [1, 3, H, W] references)."""
    fns = PhaseFns(fcfg, params, "none", "hardround", dist_weight or {"mse": 1.0},
                   (0.95, 0.95), (0.9, 0.999), 10, cr=cr)
    leaves = [x[None] for x in tree_leaves(params)]
    return logs_from_loss(fns.eval(leaves, target, lmbda, refs))


def stack_trees(trees: list):
    """Stack same-shaped trees of tensors on a new leading batch axis."""
    return tree_unflatten(trees[0], [torch.stack(xs) for xs in
                                     zip(*(tree_leaves(t) for t in trees))])


def index_tree(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def train(params: dict, fcfg: FrameConfig, target, phase: TrainerPhase, *,
          noise_source, cr: Optional[dict] = None, refs: Optional[list] = None,
          monitor: Optional[EncoderMonitor] = None, verbose: bool = False) -> dict:
    """Run one training phase of one image; returns the best parameters
    found (tensors, no batch axis). `params`: one image's tensors on the
    device; `target`: its [1, C, H, W] (or planes); `refs`: a P/B frame's
    [1, 3, H, W] references; `noise_source` as in
    parallel/encode_batch.py:_batched_phase.

    The port of coolchic_tpu/train/train.py:train (less the spatial mesh):
    SOAP bases seeded from a first gradient, an eval before the first
    window and after each, the best parameters kept, and after more than
    patience / freq_valid windows without a record either a reload of the
    best parameters (schedule_lr) or the end of the phase."""
    monitor = monitor or EncoderMonitor()
    start_time = time.time()
    like = tree_map(lambda x: x[None], params)
    leaves = [x.detach() for x in tree_leaves(like)]
    dev = leaves[0].device
    fns = PhaseFns(fcfg, like, phase.quantizer_noise_type, phase.quantizer_type,
                   phase.dist_weight, tuple(phase.betas_model), tuple(phase.betas_latent),
                   phase.precondition_frequency_model, cr=cr)
    opt = init_opt_state(leaves, fns.groups, fns.hp_weight, fns.hp_latent)
    lmbda = torch.full((1,), phase.lmbda, dtype=torch.float32, device=dev)

    def draw(kind: str, level: float):
        level_t = torch.full((1,), level, dtype=torch.float32, device=dev)
        return lambda: noise_source(kind, fcfg, 1, phase.quantizer_noise_type, level_t,
                                    fns.need_noise)

    # Reference parity: seed the SOAP eigenbases from the first gradient
    # (one extra gradient; the phase's first step then takes a fresh one).
    temp0 = linear_schedule(phase.softround_temperature, 0, phase.max_itr)
    noise0 = linear_schedule(phase.noise_parameter, 0, phase.max_itr)
    grads = fns.grads(leaves, draw("seed", noise0)(), temp0, target, lmbda, refs)
    opt = seed_opt_state(opt, grads, fns.groups, fns.hp_weight)

    best = logs_from_loss(fns.eval(leaves, target, lmbda, refs))
    initial, best_leaves = best, leaves

    n_windows = math.ceil(phase.max_itr / phase.freq_valid)
    t_max = phase.max_itr / phase.freq_valid
    patience_windows = max(phase.patience // phase.freq_valid, 1)
    cnt = 0
    windows_since_record = 0
    for w_idx in range(n_windows):
        if windows_since_record > patience_windows:
            if not phase.schedule_lr:
                break
            leaves = best_leaves
            windows_since_record = 0

        lr = cosine_lr(phase.lr, w_idx, t_max) if phase.schedule_lr else phase.lr
        temp = linear_schedule(phase.softround_temperature, cnt, phase.max_itr)
        noise = linear_schedule(phase.noise_parameter, cnt, phase.max_itr)
        n_steps = min(phase.freq_valid, phase.max_itr - cnt)
        leaves, opt = fns.window(leaves, opt, draw("step", noise), n_steps, temp,
                                 torch.tensor(lr, dtype=torch.float32, device=dev),
                                 target, lmbda, refs)
        cnt += n_steps
        monitor.iterations_counter += n_steps

        logs = logs_from_loss(fns.eval(leaves, target, lmbda, refs))
        if logs.loss < best.loss:
            best, best_leaves = logs, leaves
            windows_since_record = 0
        else:
            windows_since_record += 1
        if verbose:
            print(f"  itr {cnt:>6} loss {logs.loss * 1e3:9.4f} "
                  f"psnr {logs.psnr_db:7.3f} bpp {logs.total_rate_latent_bpp:7.4f} "
                  f"lr {lr:.5f} temp {temp:.3f} noise {noise:.3f}"
                  + ("  *" if logs.loss == best.loss else ""), flush=True)

    monitor.total_training_time_sec += time.time() - start_time
    if verbose:
        print(f"  phase done: loss {initial.loss * 1e3:.4f} -> {best.loss * 1e3:.4f} "
              f"({best.psnr_db:.3f} dB, {best.total_rate_latent_bpp:.4f} bpp)", flush=True)
    return index_tree(tree_unflatten(like, best_leaves), 0)
