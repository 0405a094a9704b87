"""Spatial (H) sharding of ONE large image over the devices of a mesh.

For 2K/4K frames, the activations of the ARM rate and of the synthesis
split along the image height: shard s computes rows [a_s, b_s) of every
grid that splits, from slabs with halos (the 4 rows above that the causal
9x9 context reads; the synthesis convs' sum of (k - 1) // 2 on each
interior side), and the rows are concatenated back on the mesh's first
device, which holds the parameters, the latents, their optimizer state,
the upsampling pyramid and the loss (models/coolchic.py says why).

The port of coolchic_tpu/parallel/spatial.py, where GSPMD places the
shards and inserts the halo exchanges. shard_spatial and shard_target keep
the JAX package's placement rule as a plan (each leaf's PartitionSpec as a
tuple), which the forward applies grid by grid (models/coolchic.py:
split_rows).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from coolchic_tpu_torch.models.frame import FrameConfig
from coolchic_tpu_torch.parallel.batch import Mesh, _hyper, make_mesh
from coolchic_tpu_torch.train.loss import LossOutput
from coolchic_tpu_torch.train.params import (
    group_tree,
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from coolchic_tpu_torch.train.train import PhaseFns, TorchNoise, init_opt_state

SPLIT = "space"


def space_submesh(mesh: Mesh) -> Mesh:
    """Every device of a (data, space) mesh on one "space" axis: a single
    big image uses the whole mesh."""
    return Mesh(tuple(mesh.devices), 1, mesh.size)


def _spec(ndim: int, split: bool) -> tuple:
    return (None,) * (ndim - 2) + (SPLIT, None) if split else ()


def shard_spatial(tree, mesh: Mesh) -> list[tuple[str, tuple]]:
    """The placement plan of a frame-encoder tree (no batch axis), as
    [(leaf path, spec)]: a latent grid, or any 4-D array, whose rows divide
    over the mesh with at least 4 rows a device splits its rows
    (spec (..., "space", None)); everything else stays whole (spec ()).
    The JAX package's rule (coolchic_tpu/parallel/spatial.py:34-53)."""
    n = mesh.size
    plan = []
    for path, x in tree_flatten_with_path(tree):
        shape = tuple(np.shape(x))
        split = (len(shape) >= 2 and shape[-2] % n == 0 and shape[-2] // n >= 4
                 and ("latents" in path or len(shape) == 4))
        plan.append((path, _spec(len(shape), split)))
    return plan


def shard_target(target, mesh: Mesh):
    """The target's plan: its rows split iff they divide over the mesh
    (coolchic_tpu/parallel/spatial.py:56-64); a dict of planes gets one
    spec per plane."""
    n = mesh.size
    if isinstance(target, dict):
        return {k: _spec(4, np.shape(v)[-2] % n == 0) for k, v in target.items()}
    return _spec(4, np.shape(target)[-2] % n == 0)


def make_spatial_train(fcfg: FrameConfig, pkey: tuple, mesh: Mesh, freq_valid: int = 16):
    """(window, evaluate, prepare) of one image trained with its rows
    split over every device of the mesh
    (coolchic_tpu/parallel/spatial.py:make_spatial_train):

      prepare(params, target, seed=0) -> (params, opt, target, key): one
        image's params (numpy or tensors, no batch axis) as a batched tree
        on the mesh's first device, fresh SOAP states, the [1, C, H, W]
        target there, and the noise generator seeded with `seed`;
      window(params, opt, key, target, lr, temp, noise, length=freq_valid,
        noise_source=None) -> (params, opt, key): `length` SOAP steps whose
        noise comes from `key` (train.TorchNoise), or from `noise_source`;
      evaluate(params, target) -> LossOutput: the decoder's view.
    """
    qnt, qt, dw, lmbda, bm, bl, pf = pkey
    space = space_submesh(mesh)
    dev = mesh.first
    hp_w, hp_l = _hyper(pkey)
    made: list = []   # the PhaseFns, made from the first params seen (one tree layout)

    def fns_for(params) -> PhaseFns:
        if not made:
            made.append(PhaseFns(fcfg, params, qnt, qt, dict(dw), bm, bl, pf, mesh=space))
        return made[0]

    def prepare(params, target, seed: int = 0):
        params = tree_map(lambda x: (x if torch.is_tensor(x) else torch.as_tensor(
            np.asarray(x, np.float32)))[None].to(dev), params)
        opt = init_opt_state(tree_leaves(params), group_tree(params), hp_w, hp_l)
        target = torch.as_tensor(np.asarray(target, np.float32), device=dev)
        key = torch.Generator(device=dev)
        key.manual_seed(seed)
        return params, opt, target, key

    def window(params, opt, key, target, lr, temp, noise, length: int = freq_valid,
               noise_source=None):
        fns = fns_for(params)
        src = noise_source or TorchNoise(key)
        level = torch.full((1,), float(noise), dtype=torch.float32, device=dev)
        lm = torch.full((1,), lmbda, dtype=torch.float32, device=dev)
        leaves, opt = fns.window(
            tree_leaves(params), opt,
            lambda: src("step", fcfg, 1, qnt, level, fns.need_noise), length, temp,
            torch.tensor(lr, dtype=torch.float32, device=dev), target, lm)
        return tree_unflatten(params, leaves), opt, key

    def evaluate(params, target) -> LossOutput:
        lm = torch.full((1,), lmbda, dtype=torch.float32, device=dev)
        return fns_for(params).eval(tree_leaves(params), target, lm)

    return window, evaluate, prepare


def resolve_spatial_shard(value, device: torch.device, n_cards: int, n_pixels: int) -> int:
    """A --spatial_shard value as a shard count: `auto` is 0 unless
    `device` is cuda, n_cards > 1 and the frame has >= 2 * 1024 * 1024
    pixels, then n_cards (the JAX CLI's rule, cc_encode.py:183-195); an
    integer N > 1 on cuda above n_cards raises ValueError with the JAX
    package's message (coolchic_tpu/train/video.py:137-139). On the CPU,
    N is N shards of the CPU."""
    if str(value) == "auto":
        if device.type == "cuda" and n_cards > 1 and n_pixels >= 2 * 1024 * 1024:
            return n_cards
        return 0
    n = int(value)
    if n > 1 and device.type == "cuda" and n > n_cards:
        raise ValueError(f"--spatial_shard {n} needs that many devices, have {n_cards}")
    return n


def spatial_mesh_for(n_shards: int, device: torch.device,
                     mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """The space mesh of an encode: `mesh` when given (it overrides),
    else n_shards > 1 devices of `device`'s type (cards 0..n-1 on cuda,
    which must all be there: resolve_spatial_shard's refusal; n entries of
    the CPU), else None."""
    if mesh is not None:
        return space_submesh(mesh)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if resolve_spatial_shard(n_shards, device, n_cards, 0) <= 1:
        return None
    return make_mesh(n_shards, space=n_shards, device=device)
