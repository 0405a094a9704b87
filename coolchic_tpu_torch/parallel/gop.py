"""GOP-level frame parallelism: dependency waves.

The reference encodes one frame per job, chained through slurm `afterok`
dependencies, with decoded reference frames handed off on disk (reference
samples/encode.py:147-183, _getcodingstruct.py:17-91). Grouped into WAVES,
every frame whose references were all decoded in earlier waves can train
now: a hierarchical GOP of depth d gives d + 1 waves, and the frames of a
wave are independent training problems that train as one batch
(train/video.py:encode_wave_group).

The port of coolchic_tpu/parallel/gop.py (gop_waves,
slurm_afterok_equivalent); the reference exchange between mesh slices
(exchange_references) belongs to the multi-device port.
"""

from __future__ import annotations

from coolchic_tpu_torch.utils.codingstructure import CodingStructure, Frame


def gop_waves(cs: CodingStructure) -> list[list[Frame]]:
    """Frames grouped into dependency waves: wave k holds every frame whose
    references all live in waves < k, sorted by display order."""
    waves: list[list[Frame]] = []
    placed: dict[int, int] = {}  # display_order -> wave index
    remaining = [cs.get_frame_from_coding_order(i)
                 for i in range(cs.get_max_coding_order() + 1)]
    while remaining:
        ready = [f for f in remaining if all(r in placed for r in f.index_references)]
        if not ready:
            raise ValueError("cyclic reference structure")
        for f in ready:
            placed[f.display_order] = len(waves)
        waves.append(sorted(ready, key=lambda f: f.display_order))
        remaining = [f for f in remaining if f.display_order not in placed]
    return waves


def slurm_afterok_equivalent(cs: CodingStructure) -> str:
    """Human-readable wave plan (what the reference emits as an sbatch
    dependency chain, _getcodingstruct.py:17-91)."""
    return "\n".join(
        f"wave {k}: " + ", ".join(f"{f.frame_type}{f.display_order}" for f in wave)
        for k, wave in enumerate(gop_waves(cs)))
