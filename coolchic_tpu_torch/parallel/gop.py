"""GOP-level frame parallelism: dependency waves.

The reference encodes one frame per job, chained through slurm `afterok`
dependencies, with decoded reference frames handed off on disk (reference
samples/encode.py:147-183, _getcodingstruct.py:17-91). Grouped into WAVES,
every frame whose references were all decoded in earlier waves can train
now: a hierarchical GOP of depth d gives d + 1 waves, and the frames of a
wave are independent training problems that train as one batch
(train/video.py:encode_wave_group).

Between waves, exchange_references puts each decoded reference on every
device of the mesh that needs it (one process: copies; several processes:
a broadcast from the rank that decoded it, parallel/dcn.py).

The port of coolchic_tpu/parallel/gop.py (gop_waves, exchange_references,
slurm_afterok_equivalent).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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


def exchange_references(decoded: dict, needed: Sequence[int], mesh,
                        owners: Optional[dict] = None) -> dict:
    """{frame index: {device: its decoded pixels there}} for each frame of
    `needed`, on every distinct device of the mesh (the JAX package's
    replicated placement, coolchic_tpu/parallel/gop.py:52-59).

    One process: `decoded` holds every needed frame, copied to each device.
    Under torch.distributed (parallel/dcn.py), `owners` maps each needed
    frame to the rank that decoded it; that rank holds it in `decoded` and
    broadcasts it (shape, then pixels), and every rank places it on its
    own mesh devices. With the gloo backend the pixels travel through the
    host."""
    import torch.distributed as dist

    out = {}
    for i in needed:
        x = decoded.get(i)
        if owners is not None:
            src = owners[i]
            meta = [None if x is None else (tuple(x.shape), x.dtype)]
            dist.broadcast_object_list(meta, src=src)
            shape, dtype = meta[0]
            on = mesh.first if dist.get_backend() == "nccl" else torch.device("cpu")
            buf = x.to(on) if dist.get_rank() == src else torch.empty(shape, dtype=dtype,
                                                                       device=on)
            dist.broadcast(buf, src=src)
            x = buf
        out[i] = {d: x.to(d) for d in mesh.distinct}
    return out


def slurm_afterok_equivalent(cs: CodingStructure) -> str:
    """Human-readable wave plan (what the reference emits as an sbatch
    dependency chain, _getcodingstruct.py:17-91)."""
    return "\n".join(
        f"wave {k}: " + ", ".join(f"{f.frame_type}{f.display_order}" for f in wave)
        for k, wave in enumerate(gop_waves(cs)))
