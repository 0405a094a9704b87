"""Float-tail parameters carried from the JAX layout into torch modules."""

from __future__ import annotations

import numpy as np
import torch

from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.models.synthesis import Synthesis
from coolchic_tpu_torch.models.upsampling import Upsampling


def params_from_jax(tree: dict, cfg: CoolChicConfig, device: torch.device | str
                    ) -> tuple[Upsampling, Synthesis]:
    """The JAX package's float-tail params as nested numpy dicts, in the
    layout of coolchic_tpu/bitstream/codec.py:_decoded_nn_to_jax
    ({"upsampling": {"tconv_half": [...], "conv_half": [...], ...},
    "synthesis": {"output_transform", "layers", "stabiliser"?}}), or the
    same dicts as decode_network returns them -> (Upsampling, Synthesis)
    on `device`."""
    def t(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    def wb(d: dict) -> dict:
        return {"weight": t(d["weight"]), "bias": t(d["bias"])}

    ups = tree["upsampling"]
    upsampling = Upsampling(cfg.ups_k_size, cfg.ups_preconcat_k_size,
                            [t(h) for h in ups["tconv_half"]],
                            [t(h) for h in ups["conv_half"]])
    syn = tree["synthesis"]
    synthesis = Synthesis(cfg, [wb(lay) for lay in syn["layers"]],
                          wb(syn["output_transform"]),
                          wb(syn["stabiliser"]) if "stabiliser" in syn else None)
    return upsampling, synthesis


def tree_from_numpy(tree, device: torch.device | str):
    """A nested dict/list of numpy arrays (a JAX params or SOAP-state tree
    moved to the host) as f32/int32 tensors on `device`, in the same
    layout: the trainable frame params (latents, ARM, IFCE, upsampling,
    synthesis, global flows) go straight into the port's forward."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    return torch.as_tensor(a.astype(np.int32 if a.dtype.kind in "iu" else np.float32),
                           device=device)


def tree_to_numpy(tree):
    """The way back: tensors (and None) of a port tree as numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    return None if tree is None else tree.detach().cpu().numpy()


def soap_state_from_jax(state: dict | None, device: torch.device | str) -> dict | None:
    """One leaf's SOAP state of the JAX package (coolchic_tpu/train/soap.py:
    soap_init_leaf layout, with a leading batch axis as _batched_phase holds
    it) as the port's: {"step", "exp_avg", "exp_avg_sq", "GG", "Q"}, None
    for a dimension the JAX state marks with an empty placeholder."""
    if state is None:
        return None

    def mats(xs):
        return [None if np.asarray(x).shape[-1] == 0 else tree_from_numpy(x, device)
                for x in xs]

    return {"step": tree_from_numpy(state["step"], device),
            "exp_avg": tree_from_numpy(state["exp_avg"], device),
            "exp_avg_sq": tree_from_numpy(state["exp_avg_sq"], device),
            "GG": mats(state["GG"]), "Q": mats(state["Q"])}
