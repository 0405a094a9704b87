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
