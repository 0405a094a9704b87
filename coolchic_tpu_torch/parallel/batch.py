"""Multi-device scale-out: the mesh, and the "data" axis of independent
images.

Two axes, as in the JAX package (coolchic_tpu/parallel/batch.py):

1. "data": images, frames or rate points are independent optimization
   problems. Each data device holds a contiguous chunk of the batch slots
   (their params, optimizer state, targets, rate points and noise
   streams) and advances it with no traffic between devices.
2. "space": one large image's rows split over devices
   (models/coolchic.py, parallel/spatial.py).

JAX runs one GSPMD / shard_map program that places the shards; the port is
ONE Python process that puts each shard's tensors on its device and
launches the shards' work device after device (the launches are
asynchronous, so the devices overlap). Autograd carries gradients across
devices, since `.to()` is differentiable; only parallel/dcn.py spans
processes.

A Mesh may name one device several times: that is how the tests (on the
CPU) and a one-card run get meshes of 2-8 shards, as the JAX package's
tests get eight virtual CPU devices. On `cuda`, a mesh that names a
missing card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from coolchic_tpu_torch.core.device import resolve_device
from coolchic_tpu_torch.models.frame import FrameConfig, frame_encoder_init
from coolchic_tpu_torch.train.params import group_tree, tree_leaves, tree_map, tree_unflatten
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.soap import SoapHyperParams
from coolchic_tpu_torch.train.train import (
    PhaseFns,
    SlotNoise,
    _frame_phase_generator,
    init_opt_state,
    stack_trees,
)

__all__ = ["Mesh", "make_mesh", "stack_trees", "phase_key", "batched_init", "shard_batch",
           "gather_batch", "make_batched_window", "make_spatial_synthesis"]


def _check_device(d: torch.device) -> torch.device:
    """d itself, with a CUDA index made explicit; raises for a card that is
    not there."""
    d = resolve_device(d)
    if d.type == "cuda":
        idx = torch.cuda.current_device() if d.index is None else d.index
        if idx >= torch.cuda.device_count():
            raise ValueError(f"the mesh names {d}, but torch sees "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        d = torch.device("cuda", idx)
    return d


@dataclass(frozen=True)
class Mesh:
    """A (data, space) grid of devices, flattened row-major: data slice i
    is devices[i * space:(i + 1) * space]. A device may repeat."""

    devices: tuple
    data: int
    space: int

    def __post_init__(self):
        if len(self.devices) != self.data * self.space or not self.devices:
            raise ValueError(f"{len(self.devices)} devices for a ({self.data}, "
                             f"{self.space}) mesh")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> tuple:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def data_devices(self) -> tuple:
        """The device that holds each data slice's chunk (its first)."""
        return tuple(self.devices[i * self.space] for i in range(self.data))


def make_mesh(n_devices: Optional[int] = None, space: int = 1, *,
              device: str | torch.device = "cuda",
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, space) mesh over `devices` (an explicit list, repeats
    allowed), else over the first n_devices visible cards of `device`'s
    type (all of them by default; on the CPU, n_devices entries of the
    CPU). data = len(devices) // space."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            n = n_devices or count
            if n > count:
                raise ValueError(f"a mesh of {n} cards asked for, torch sees {count}")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [dev] * (n_devices or 1)
    devices = tuple(_check_device(torch.device(d)) for d in devices)
    if len(devices) % space:
        raise ValueError(f"{len(devices)} devices do not split into space = {space}")
    return Mesh(devices, len(devices) // space, space)


def phase_key(phase: TrainerPhase) -> tuple:
    """The phase settings a batched window depends on (JAX's cache key)."""
    return (phase.quantizer_noise_type, phase.quantizer_type,
            tuple(sorted(phase.dist_weight.items())), phase.lmbda,
            tuple(phase.betas_model), tuple(phase.betas_latent),
            phase.precondition_frequency_model)


def _hyper(pkey: tuple) -> tuple[SoapHyperParams, SoapHyperParams]:
    _, _, _, _, bm, bl, pf = pkey
    return (SoapHyperParams(b1=bm[0], b2=bm[1], weight_decay=0.01,
                            precondition_frequency=pf, max_precond_dim=256),
            SoapHyperParams(b1=bl[0], b2=bl[1], weight_decay=0.0,
                            precondition_frequency=1, max_precond_dim=0))


def batched_init(fcfg: FrameConfig, phase: TrainerPhase, n: int, seed: int = 0,
                 device: str | torch.device = "cuda") -> tuple[dict, list]:
    """Stacked params of n images (slot i drawn from its own generator)
    and their fresh SOAP states, every slot's the same (JAX broadcasts one
    image's state, coolchic_tpu/parallel/batch.py:50-63): (params tree,
    list of states in leaf order)."""
    dev = resolve_device(device)
    params = stack_trees([frame_encoder_init(_frame_phase_generator(seed, i, -2, dev), fcfg,
                                             device=dev) for i in range(n)])
    hp_w, hp_l = _hyper(phase_key(phase))
    opt = init_opt_state(tree_leaves(params), group_tree(params), hp_w, hp_l)
    return params, opt


def _map(fn, tree):
    """fn over every tensor of a nest of dicts and lists (None kept)."""
    return tree_map(lambda x: None if x is None else fn(x), tree)


def chunk_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous slot ranges of n slots over `parts` devices (JAX's
    P("data")); n must divide evenly."""
    if n % parts:
        raise ValueError(f"a batch of {n} does not split over {parts} data devices")
    k = n // parts
    return [(i * k, (i + 1) * k) for i in range(parts)]


def shard_batch(tree, mesh: Mesh) -> list:
    """A stacked nest (params, states, targets, ...) as one chunk per data
    slice of the mesh: chunk i holds the contiguous slots of slice i, on
    its device."""
    n = next(x for x in tree_leaves(tree) if x is not None).shape[0]
    return [_map(lambda x, a=a, b=b, d=d: x[a:b].to(d), tree)
            for (a, b), d in zip(chunk_bounds(n, mesh.data), mesh.data_devices())]


def gather_batch(chunks: list, device: torch.device):
    """The inverse of shard_batch: the chunks concatenated on `device`."""
    return tree_unflatten(chunks[0], [
        None if xs[0] is None else torch.cat([x.to(device) for x in xs])
        for xs in zip(*map(tree_leaves, chunks))])


def window_chunks(fns: list, chunks: list, draws: list, n_steps: int, temp,
                  lrs: list, targets: list, lmbdas: list, refs: list) -> list:
    """n_steps training steps of every chunk ((leaves, states) on its
    device, fns[c] its PhaseFns): step by step, chunk after chunk, with no
    host sync, so the devices overlap; the eigenbasis refresh every
    precondition_frequency steps, as PhaseFns.window."""
    pf = fns[0].pf
    chunks = list(chunks)
    for s in range(n_steps):
        for c, (leaves, states) in enumerate(chunks):
            chunks[c] = fns[c].step(leaves, states, draws[c](), temp, lrs[c], targets[c],
                                    lmbdas[c], refs[c], refresh=(s + 1) % pf == 0)
    return chunks


def make_batched_window(fcfg: FrameConfig, pkey: tuple, freq_valid: int, mesh: Mesh):
    """fn(params, opt, keys, lr, temp, noise, targets) -> (params, opt,
    keys): each data slice advances its slots by freq_valid training steps
    (coolchic_tpu/parallel/batch.py:make_batched_window). params: stacked
    tree; opt: batched_init's state list; keys: one torch.Generator per
    slot (on its slot's device: SlotNoise streams); lr, temp, noise:
    floats; targets [n, C, H, W]. The slots come back on the mesh's first
    device."""
    qnt, qt, dw, lmbda, bm, bl, pf = pkey

    def fn(params, opt, keys, lr, temp, noise, targets):
        fns = PhaseFns(fcfg, params, qnt, qt, dict(dw), bm, bl, pf)
        n = tree_leaves(params)[0].shape[0]
        bounds, devs = chunk_bounds(n, mesh.data), mesh.data_devices()
        chunks = [(tree_leaves(p), o) for p, o in zip(shard_batch(params, mesh),
                                                      shard_batch(opt, mesh))]
        draws = []
        for (a, b), d in zip(bounds, devs):
            src = SlotNoise(keys[a:b])
            level = torch.full((b - a,), float(noise), dtype=torch.float32, device=d)
            draws.append(lambda src=src, g=b - a, lv=level:
                         src("step", fcfg, g, qnt, lv, fns.need_noise))
        chunks = window_chunks(
            [fns] * len(devs), chunks, draws, freq_valid, temp,
            [torch.tensor(lr, dtype=torch.float32, device=d) for d in devs],
            shard_batch(targets, mesh),
            [torch.full((b - a,), lmbda, dtype=torch.float32, device=d)
             for (a, b), d in zip(bounds, devs)], [None] * len(devs))
        leaves = gather_batch([c[0] for c in chunks], mesh.first)
        states = gather_batch([c[1] for c in chunks], mesh.first)
        return tree_unflatten(params, leaves), states, keys

    return fn


def make_spatial_synthesis(fcfg: FrameConfig, mesh: Mesh):
    """run(params) -> the decoded image: the decode-side float path
    (hardround latents, upsampling, synthesis, rounding) of ONE image with
    its rows split over every device of the mesh
    (coolchic_tpu/parallel/batch.py:make_spatial_synthesis). params: one
    image's tensors (no batch axis) on the mesh's first device."""
    from coolchic_tpu_torch.models.frame import frame_encoder_forward
    from coolchic_tpu_torch.parallel.spatial import space_submesh
    from coolchic_tpu_torch.train.params import tree_map

    space = space_submesh(mesh)

    def run(params):
        with torch.no_grad():
            batched = tree_map(lambda x: x[None].to(mesh.first), params)
            out = frame_encoder_forward(batched, fcfg, training=False, mesh=space)
        return out.decoded_image

    return run
