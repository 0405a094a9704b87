"""Frame-encoder checkpointing (save / resume).

Serializes the parameter tree + NN-quantization side info + frame config to
a single .npz in the JAX package's layout and keys
(coolchic_tpu/utils/checkpoint.py), so either package resumes the other's
checkpoints. Per-frame idempotence: re-running an already-encoded frame is
skipped when its checkpoint exists (reference cc_encode.py:363-419).
"""

from __future__ import annotations

import json

import numpy as np

from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.models.frame import FrameConfig

_CFG_KEYS = ("layers_synthesis", "linear_stabiliser_synth", "ups_k_size",
             "ups_preconcat_k_size", "ifce_resolution", "output_feature_ifce",
             "spatial_context_arm", "linear_stabiliser_arm", "n_hidden_layers_arm",
             "latent_resolution", "hyperlatent_resolution", "flag_common_randomness",
             "img_size", "final_upsampling_type", "encoder_gain")


def _flatten(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = (tree.detach().cpu().numpy() if hasattr(tree, "detach")
                            else np.asarray(tree))
    return out


def _unflatten(flat: dict):
    # Rebuild nested dict/list structure from "a/b/0/c" keys.
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_frame_encoder(path: str, params: dict, fcfg: FrameConfig,
                       nn_side_info: dict | None = None) -> None:
    meta = {
        "fcfg": {
            "coolchic_cfg": {name: {k: getattr(cfg, k) for k in _CFG_KEYS}
                             for name, cfg in fcfg.cc_cfgs.items()},
            "frame_type": fcfg.frame_type,
            "frame_data_type": fcfg.frame_data_type,
            "bitdepth": fcfg.bitdepth,
            "index_references": list(fcfg.index_references),
            "frame_display_index": fcfg.frame_display_index,
            "warp_filter_size": fcfg.warp_filter_size,
        },
        "nn_side_info": {
            name: {"q_shift": [[list(k), v] for k, v in q.items()],
                   "expgol": [[list(k), v] for k, v in e.items()]}
            for name, (q, e) in (nn_side_info or {}).items()
        },
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **_flatten(params))


def load_frame_encoder(path: str):
    """Returns (params as numpy arrays, fcfg, nn_side_info)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    params = _unflatten({k: data[k] for k in data.files if k != "__meta__"})

    cfgs = {}
    for name, kw in meta["fcfg"]["coolchic_cfg"].items():
        kw = dict(kw)
        for tup_key in ("ifce_resolution", "latent_resolution",
                        "hyperlatent_resolution", "img_size"):
            if kw[tup_key] is not None:
                kw[tup_key] = tuple(kw[tup_key])
        kw["layers_synthesis"] = tuple(kw["layers_synthesis"])
        cfgs[name] = CoolChicConfig(**kw)

    fc = meta["fcfg"]
    fcfg = FrameConfig(coolchic_cfg=cfgs, frame_type=fc["frame_type"],
                       frame_data_type=fc["frame_data_type"], bitdepth=fc["bitdepth"],
                       index_references=tuple(fc["index_references"]),
                       frame_display_index=fc["frame_display_index"],
                       warp_filter_size=fc["warp_filter_size"])

    nn_side_info = {
        name: ({tuple(k): v for k, v in d["q_shift"]},
               {tuple(k): v for k, v in d["expgol"]})
        for name, d in meta["nn_side_info"].items()
    }
    return params, fcfg, nn_side_info
