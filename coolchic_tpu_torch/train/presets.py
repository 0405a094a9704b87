"""Encoding presets: warm-up tournaments + training phase schedules.

All hyperparameters mirror the reference presets
(coolchic/training/presets.py:299-571) through the JAX package's copy
(coolchic_tpu/train/presets.py): intra (2 warm-up stages of 5 then 2
candidates, softround/gaussian main phase with temperature 0.35->0.08 and
noise 0.22->0.15, lambda-dependent warm-up noise, 500-iteration hardround
fine-tune at lr 1e-4), inter (one 2-candidate warm-up stage, a single
softround phase, the motion pretraining phase at 20 x lambda), debug and
measure_speed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class TrainerPhase:
    lmbda: float
    lr: float = 1e-2
    betas_model: Tuple[float, float] = (0.95, 0.95)
    betas_latent: Tuple[float, float] = (0.9, 0.999)
    precondition_frequency_model: int = 10
    max_itr: int = 5000
    freq_valid: int = 100
    patience: int = 10000
    schedule_lr: bool = False
    softround_temperature: Tuple[float, float] = (0.3, 0.3)
    noise_parameter: Tuple[float, float] = (1.0, 1.0)
    quantizer_noise_type: str = "kumaraswamy"
    quantizer_type: str = "softround"
    dist_weight: Dict[str, float] = field(default_factory=lambda: {"mse": 1.0})


@dataclass
class WarmupPhase:
    candidates: int
    training_phase: TrainerPhase


@dataclass
class Warmup:
    phases: List[WarmupPhase] = field(default_factory=list)

    def total_iterations(self) -> int:
        return sum(p.candidates * p.training_phase.max_itr for p in self.phases)


@dataclass
class Preset:
    lmbda: float
    start_lr: float
    itr_main_training: int
    precondition_frequency_model: int = 10
    preset_name: str = ""
    itr_motion_pretrain: int = 0
    dist_weight: Dict[str, float] = field(default_factory=lambda: {"mse": 1.0})
    motion_pretrain_phase: List[TrainerPhase] = field(default_factory=list, init=False)
    warmup: Warmup = field(default_factory=Warmup, init=False)
    training_phases: List[TrainerPhase] = field(default_factory=list, init=False)

    def __post_init__(self):
        # Base hook so the dataclass-generated __init__ dispatches to the
        # concrete preset's __post_init__ (subclasses are not re-decorated).
        pass

    def warmup_noise_parameter(self, lmbda: float):
        """Warm-up noise_parameter a slot at rate point `lmbda` would get if
        the preset were built for that λ; None when the preset's warm-up
        noise is not λ-derived. Lets a mixed-λ batch keep the reference's
        λ-dependent warm-up noise per slot (reference
        training/presets.py:311)."""
        return None


def _intra_warmup_noise_level(lmbda: float) -> float:
    """λ-dependent warm-up init noise (reference training/presets.py:311)."""
    return (-0.432 * math.log10(lmbda) + 0.747) / 10.0


@dataclass
class PresetIntra(Preset):
    """`itr_floor` below 2000 relaxes the production minimum of 2000
    iterations for short smoke schedules: under 2000 the STE tail is a
    fifth of the budget and each warm-up stage a tenth (the JAX package's
    COOLCHIC_ITR_FLOOR schedule, here a keyword)."""

    itr_floor: int = field(default=2000, repr=False)

    def warmup_noise_parameter(self, lmbda: float):
        lvl = _intra_warmup_noise_level(lmbda)
        return (lvl, lvl)

    def __post_init__(self):
        self.preset_name = "intra"
        floor = min(2000, self.itr_floor)
        if self.itr_main_training < floor:
            raise ValueError(f"intra preset requires --n_itr >= {floor}")

        init_noise_level = _intra_warmup_noise_level(self.lmbda)

        # production keeps the 500-iteration STE tail; a relaxed-floor
        # budget scales it down so the core phase stays positive
        iter_ste_training = (500 if self.itr_main_training >= 2000
                             else max(self.itr_main_training // 5, 1))
        iter_core_training = self.itr_main_training - iter_ste_training

        wu_n_iter = 400
        if self.itr_main_training < 2000:
            wu_n_iter = max(self.itr_main_training // 10, 1)
        elif self.itr_main_training < 4000:
            wu_n_iter = 50
        elif self.itr_main_training < 9000:
            wu_n_iter = 100
        elif self.itr_main_training < 12000:
            wu_n_iter = 200

        wu_stages = []
        candidates = 5
        for _ in range(2):
            wu_stages.append(WarmupPhase(
                candidates=candidates,
                training_phase=TrainerPhase(
                    lr=self.start_lr, max_itr=wu_n_iter, freq_valid=100,
                    patience=wu_n_iter, schedule_lr=False,
                    softround_temperature=(0.35, 0.35),
                    noise_parameter=(init_noise_level, init_noise_level),
                    quantizer_noise_type="gaussian", quantizer_type="softround",
                    lmbda=self.lmbda, dist_weight={"mse": 1.0},
                    betas_latent=(0.725, 0.97), betas_model=(0.95, 0.95),
                    precondition_frequency_model=1,
                ),
            ))
            iter_core_training -= candidates * wu_n_iter
            candidates = 2
        self.warmup = Warmup(wu_stages)

        self.training_phases = [
            TrainerPhase(
                lr=self.start_lr, max_itr=iter_core_training, patience=5000,
                schedule_lr=True, quantizer_type="softround",
                quantizer_noise_type="gaussian",
                softround_temperature=(0.35, 0.08), noise_parameter=(0.22, 0.15),
                lmbda=self.lmbda, dist_weight=self.dist_weight,
                betas_latent=(0.9, 0.999), betas_model=(0.95, 0.95),
                precondition_frequency_model=10,
            ),
            TrainerPhase(
                lr=1.0e-4, max_itr=iter_ste_training, schedule_lr=True,
                quantizer_type="hardround", quantizer_noise_type="none",
                lmbda=self.lmbda, dist_weight=self.dist_weight,
                betas_latent=(0.9, 0.999), betas_model=(0.95, 0.95),
                precondition_frequency_model=10,
            ),
        ]


class PresetInter(Preset):
    def __post_init__(self):
        self.preset_name = "inter"
        self.training_phases = [
            TrainerPhase(
                lr=self.start_lr, max_itr=self.itr_main_training, patience=5000,
                schedule_lr=True, quantizer_type="softround",
                quantizer_noise_type="gaussian",
                softround_temperature=(0.3, 0.1), noise_parameter=(0.25, 0.1),
                lmbda=self.lmbda, dist_weight=self.dist_weight,
                betas_latent=(0.9, 0.999), betas_model=(0.95, 0.95),
                precondition_frequency_model=10,
            ),
        ]
        self.warmup = Warmup([
            WarmupPhase(candidates=2, training_phase=TrainerPhase(
                lr=self.start_lr, max_itr=600, freq_valid=600, patience=100000,
                schedule_lr=False, softround_temperature=(0.3, 0.3),
                noise_parameter=(2.0, 2.0), quantizer_noise_type="kumaraswamy",
                quantizer_type="softround", lmbda=self.lmbda,
                dist_weight={"mse": 1.0}, betas_latent=(0.725, 0.97),
                betas_model=(0.95, 0.95), precondition_frequency_model=1,
            )),
        ])
        self.motion_pretrain_phase = [
            TrainerPhase(
                lr=1e-2, max_itr=self.itr_motion_pretrain,
                patience=self.itr_motion_pretrain, schedule_lr=False,
                softround_temperature=(0.3, 0.3), noise_parameter=(2.0, 2.0),
                quantizer_noise_type="kumaraswamy", quantizer_type="softround",
                lmbda=20 * self.lmbda, dist_weight={"mse": 1.0},
                betas_latent=(0.9, 0.999), betas_model=(0.95, 0.95),
                precondition_frequency_model=10,
            ),
        ]


class PresetDebug(Preset):
    """Very fast schedule, for testing the plumbing only.

    NOTE: the schedule is FIXED at 50+10 iterations; `itr_main_training` is
    deliberately ignored so `--recipe debug` stays fast regardless of the
    CLI's 10k default. A tool that wants a debug-shaped preset at a real
    budget must override `training_phases[0].max_itr` itself (see
    tools/ab_rdoq_modules.py)."""

    def __post_init__(self):
        self.preset_name = "debug"
        self.training_phases = [
            TrainerPhase(
                lr=self.start_lr, max_itr=50, patience=100000, schedule_lr=True,
                quantizer_type="softround", quantizer_noise_type="gaussian",
                softround_temperature=(0.35, 0.08), noise_parameter=(0.22, 0.15),
                lmbda=self.lmbda, dist_weight=self.dist_weight,
            ),
            TrainerPhase(
                lr=1e-4, max_itr=10, patience=10, quantizer_type="ste",
                quantizer_noise_type="none", softround_temperature=(1e-4, 1e-4),
                noise_parameter=(1.0, 1.0), lmbda=self.lmbda,
                dist_weight=self.dist_weight,
            ),
        ]
        self.warmup = Warmup([
            WarmupPhase(candidates=3, training_phase=TrainerPhase(max_itr=10, lmbda=self.lmbda)),
            WarmupPhase(candidates=2, training_phase=TrainerPhase(max_itr=10, lmbda=self.lmbda)),
        ])
        self.motion_pretrain_phase = [
            TrainerPhase(
                lr=self.start_lr, max_itr=50, patience=50, schedule_lr=True,
                quantizer_type="softround", quantizer_noise_type="gaussian",
                softround_temperature=(0.3, 0.1), noise_parameter=(0.25, 0.1),
                lmbda=self.lmbda, dist_weight=self.dist_weight,
            ),
        ]


class PresetMeasureSpeed(Preset):
    def __post_init__(self):
        self.preset_name = "measure_speed"
        self.training_phases = [
            TrainerPhase(
                lr=self.start_lr, max_itr=self.itr_main_training, patience=5000,
                schedule_lr=True, quantizer_type="softround",
                quantizer_noise_type="gaussian",
                softround_temperature=(0.3, 0.1), noise_parameter=(0.25, 0.1),
                lmbda=self.lmbda, dist_weight=self.dist_weight,
            ),
        ]
        self.warmup = Warmup([
            WarmupPhase(candidates=1, training_phase=TrainerPhase(
                lr=self.start_lr, max_itr=1, freq_valid=1, patience=100000,
                schedule_lr=False, softround_temperature=(0.3, 0.3),
                noise_parameter=(2.0, 2.0), quantizer_noise_type="kumaraswamy",
                quantizer_type="softround", lmbda=self.lmbda, dist_weight={"mse": 1.0},
            )),
        ])


AVAILABLE_PRESETS = {
    "intra": PresetIntra,
    "inter": PresetInter,
    "debug": PresetDebug,
    "measure_speed": PresetMeasureSpeed,
}
