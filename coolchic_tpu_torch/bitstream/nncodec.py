"""Decoding of the four neural networks from the bitstream.

All parameters are flattened in normative order -- modules (arm, ifce,
upsampling, synthesis), within each module all weights then all biases, each
group in registration order -- quantized by the module's power-of-two q_step
and exp-Golomb coded with the module's order.

ARM / IFCE parameters stay integers after decoding (the fixed-point path
consumes the quantized integers directly); upsampling / synthesis parameters
are dequantized to float.

Reference parity: coolchic/bitstream/neuralnet/neuralnet.py.
"""

from __future__ import annotations

import numpy as np

from coolchic_tpu_torch.bitstream.expgolomb import decode_exp_golomb
from coolchic_tpu_torch.bitstream.headers import MODULE_ORDER, WB_ORDER
from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.models.upsampling import half_param_size


# ---------------------------------------------------------------------------
# Parameter shape manifests (normative ordering).
# ---------------------------------------------------------------------------
def arm_param_shapes(cfg: CoolChicConfig) -> dict:
    dim = cfg.total_context_arm
    weights = [(dim, dim)] * cfg.n_hidden_layers_arm + [(2, dim)]
    biases = [(dim,)] * cfg.n_hidden_layers_arm + [(2,)]
    if cfg.linear_stabiliser_arm:
        weights.append((2, dim))
        biases.append((2,))
    return {"weight": weights, "bias": biases}


def ifce_param_shapes(cfg: CoolChicConfig) -> dict:
    weights, biases = [], []
    if cfg.flag_ifce:
        for in_ft in cfg.input_features_ifce:
            if in_ft == 0:
                continue
            weights.append((cfg.output_feature_ifce, in_ft))
            biases.append((cfg.output_feature_ifce,))
    return {"weight": weights, "bias": biases}


def upsampling_param_shapes(cfg: CoolChicConfig) -> dict:
    n = cfg.n_ups
    weights = [(half_param_size(cfg.ups_k_size),)] * n \
        + [(half_param_size(cfg.ups_preconcat_k_size),)] * n
    biases = [(1,)] * (2 * n)
    return {"weight": weights, "bias": biases}


def synthesis_param_shapes(cfg: CoolChicConfig) -> dict:
    out_ft_final = cfg.synthesis_out_ft
    weights = [(out_ft_final, out_ft_final, 1, 1)]  # output_transform
    biases = [(out_ft_final,)]
    if cfg.linear_stabiliser_synth:
        n_in_stab = (cfg.input_feature_synthesis // 2 if cfg.flag_common_randomness
                     else cfg.input_feature_synthesis)
        weights.append((out_ft_final, n_in_stab, 1, 1))
        biases.append((out_ft_final,))
    in_ft = cfg.input_feature_synthesis
    for out_ft, k, _, _ in cfg.parsed_synthesis:
        weights.append((out_ft, in_ft, k, k))
        biases.append((out_ft,))
        in_ft = out_ft
    return {"weight": weights, "bias": biases}


def module_param_shapes(cfg: CoolChicConfig, module: str) -> dict:
    return {
        "arm": arm_param_shapes,
        "ifce": ifce_param_shapes,
        "upsampling": upsampling_param_shapes,
        "synthesis": synthesis_param_shapes,
    }[module](cfg)


# ---------------------------------------------------------------------------
# Unflatten from the manifest order into the model param layout.
# ---------------------------------------------------------------------------
def unflatten_module_params(arrays: list[np.ndarray], cfg: CoolChicConfig, module: str,
                            wb: str, into: dict) -> None:
    """Writes manifest-ordered arrays of one module into the param dict."""
    it = iter(arrays)
    if module == "arm":
        arm = into.setdefault("arm", {"layers": [
            {} for _ in range(cfg.n_hidden_layers_arm + 1)]})
        for lay in arm["layers"]:
            lay[wb] = next(it)
        if cfg.linear_stabiliser_arm:
            arm.setdefault("stabiliser", {})[wb] = next(it)
    elif module == "ifce":
        if not cfg.flag_ifce:
            return
        n_active = sum(1 for f in cfg.input_features_ifce if f > 0)
        ifce = into.setdefault("ifce", {"arms": [{"layers": [{}]} for _ in range(n_active)]})
        for a in ifce["arms"]:
            a["layers"][0][wb] = next(it)
    elif module == "upsampling":
        n = cfg.n_ups
        ups = into.setdefault("upsampling", {})
        arrays = list(it)
        if wb == "weight":
            ups["tconv_half"] = arrays[:n]
            ups["conv_half"] = arrays[n:]
        else:
            ups["tconv_bias"] = arrays[:n]
            ups["conv_bias"] = arrays[n:]
    elif module == "synthesis":
        syn = into.setdefault("synthesis", {"output_transform": {}, "layers": [
            {} for _ in cfg.parsed_synthesis]})
        syn["output_transform"][wb] = next(it)
        if cfg.linear_stabiliser_synth:
            syn.setdefault("stabiliser", {})[wb] = next(it)
        for lay in syn["layers"]:
            lay[wb] = next(it)
    else:
        raise ValueError(module)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def decode_network(payload: bytes, cfg: CoolChicConfig, q_step_shift: dict,
                   expgol_cnt: dict, n_pad_bits: int) -> dict:
    """Decode NN parameters. Returns a model param dict (numpy arrays):
    int64 for arm/ifce (fed to the fixed-point path), float32 (dequantized)
    for upsampling/synthesis."""
    manifests = {m: module_param_shapes(cfg, m) for m in MODULE_ORDER}
    counts: list[int] = []
    for module in MODULE_ORDER:
        for wb in WB_ORDER:
            n = sum(int(np.prod(s)) for s in manifests[module][wb])
            counts.extend([expgol_cnt[(module, wb)]] * n)

    values = decode_exp_golomb(payload, n_pad_bits, counts)

    out: dict = {}
    ptr = 0
    for module in MODULE_ORDER:
        for wb in WB_ORDER:
            arrays = []
            for shape in manifests[module][wb]:
                n = int(np.prod(shape))
                chunk = values[ptr:ptr + n].reshape(shape)
                ptr += n
                if module in ("arm", "ifce"):
                    arrays.append(chunk.astype(np.int64))
                else:
                    q_step = 2.0 ** q_step_shift[(module, wb)]
                    arrays.append((chunk.astype(np.float64) * q_step).astype(np.float32))
            unflatten_module_params(arrays, cfg, module, wb, out)
    return out
