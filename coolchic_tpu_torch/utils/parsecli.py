"""Architecture DSL parsing + the decoder operating points.

DSLs (reference coolchic/utils/parsecli.py, coolchic_tpu/utils/parsecli.py):
  - synthesis: "48-1-linear-relu,3-1-linear-none,.../stabiliser"; the literal
    out-feature "X" is substituted per frame type (3 for an I residue);
  - ARM: "<n_ctx>,<n_hidden>[/stabiliser]";
  - latent / hyperlatent resolution: "lo-hi", "no", or "auto" (floor chosen
    from the pixel count: <1M -> 1/64, <3M -> 1/128, else 1/256);
  - ifce resolution: "lo-hi" or "no";
  - frame position DSL for --intra_pos/--p_pos: "0,4-7,-2".

The operating points are read from the repo's cfg/dec/*/*.cfg files:
intra (lop/mop/hop/vhop), residue of P/B frames (vlop/lop/mop/hop) and
motion (lop/mop).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Tuple

from coolchic_tpu_torch.core.arch import CoolChicConfig
from coolchic_tpu_torch.utils.configfile import parse_config_file

CFG_DIR = Path(__file__).resolve().parents[2] / "cfg" / "dec"


def parse_synthesis_layers(layers: str) -> tuple[list[str], bool]:
    stabiliser = layers.endswith("/stabiliser")
    if stabiliser:
        layers = layers[: -len("/stabiliser")]
    return [x for x in layers.split(",") if x], stabiliser


def parse_arm(arm: str) -> dict:
    stabiliser = arm.endswith("/stabiliser")
    if stabiliser:
        arm = arm[: -len("/stabiliser")]
    n_ctx, n_hidden = [int(x) for x in arm.split(",")]
    return {"spatial_context_arm": n_ctx, "n_hidden_layers_arm": n_hidden,
            "linear_stabiliser_arm": stabiliser}


def _auto_floor(n_pixels: int) -> int:
    if n_pixels < 1_000_000:
        return 6
    if n_pixels < 3_000_000:
        return 7
    return 8


def parse_latent_resolution(s: str, n_pixels: int) -> Tuple[int, int]:
    if s == "auto":
        return (0, _auto_floor(n_pixels))
    return tuple(int(x) for x in s.split("-") if x != "")


def parse_hyperlatent_resolution(s: str, n_pixels: int) -> Optional[Tuple[int, int]]:
    if s == "no":
        return None
    if s == "auto":
        return (4, _auto_floor(n_pixels))
    return tuple(int(x) for x in s.split("-") if x != "")


def parse_ifce_resolution(s: str) -> Optional[Tuple[int, int]]:
    return None if s == "no" else tuple(int(x) for x in s.split("-") if x != "")


def parse_frame_positions(s: str, n_frames: int) -> list[int]:
    """"0,4-7,-2" -> [0, 4, 5, 6, 7, n_frames - 2]."""
    out: list[int] = []
    if not s:
        return out
    for tok in s.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "-" in tok.lstrip("-"):
            # range a-b (careful with a leading minus sign)
            neg = tok.startswith("-")
            body = tok[1:] if neg else tok
            a, b = body.split("-")
            a, b = int(a), int(b)
            if neg:
                a = -a
            out.extend(range(a, b + 1))
        else:
            v = int(tok)
            out.append(v if v >= 0 else n_frames + v)
    return sorted(dict.fromkeys(v if v >= 0 else n_frames + v for v in out))


def substitute_x_channels(layers: list[str], out_ft: int) -> list[str]:
    """Replace the literal 'X' output-feature with the frame-derived count
    (reference component/video.py:103-119)."""
    return [lay.replace("X", str(out_ft)) if lay.startswith("X") else lay for lay in layers]


def synthesis_out_ft(coolchic_name: str, frame_type: str) -> int:
    """Output channels: residue I->3, P->4 (+alpha), B->5 (+alpha,beta);
    motion P->2, B->4 (two flows)."""
    if coolchic_name == "residue":
        return {"I": 3, "P": 4, "B": 5}[frame_type]
    return {"P": 2, "B": 4}[frame_type]


@lru_cache(maxsize=None)
def _operating_points(kind: str, suffix: str) -> Dict[str, Dict[str, str]]:
    """{name: cfg-style string dict} from cfg/dec/<kind>/<name>.cfg, keys
    without `suffix`."""
    points = {}
    for path in sorted(CFG_DIR.glob(f"{kind}/*.cfg")):
        points[path.stem] = {k.removesuffix(suffix): v
                             for k, v in parse_config_file(str(path)).items()}
    if not points:
        raise FileNotFoundError(f"no {kind} operating points under {CFG_DIR}")
    return points


def intra_operating_points() -> Dict[str, Dict[str, str]]:
    """The intra decoders, cfg/dec/intra/*.cfg."""
    return _operating_points("intra", "_residue")


def residue_operating_points() -> Dict[str, Dict[str, str]]:
    """The residue decoders of P/B frames, cfg/dec/residue/*.cfg."""
    return _operating_points("residue", "_residue")


def motion_operating_points() -> Dict[str, Dict[str, str]]:
    """The motion decoders, cfg/dec/motion/*.cfg (warp_filter_size among
    the keys)."""
    return _operating_points("motion", "_motion")


def coolchic_config_from_args(cfg_args: Dict[str, str], img_size: Tuple[int, int],
                              coolchic_name: str = "residue", frame_type: str = "I",
                              tune: str = "mse") -> CoolChicConfig:
    """Build a CoolChicConfig from a cfg-style string dict (an operating
    point or user overrides) for the residue or motion cool-chic of an I,
    P or B frame. The motion decoder's final upsampling is nearest; common
    randomness (--tune wasserstein) applies to the residue only."""
    n_pixels = img_size[0] * img_size[1]
    layers, stab_synth = parse_synthesis_layers(cfg_args["layers_synthesis"])
    layers = substitute_x_channels(layers, synthesis_out_ft(coolchic_name, frame_type))
    arm = parse_arm(cfg_args["arm"])

    output_feature_ifce = int(cfg_args["output_feature_ifce"])
    ifce_resolution = parse_ifce_resolution(cfg_args["ifce_resolution"])
    if ifce_resolution is None:
        output_feature_ifce = 0

    return CoolChicConfig(
        layers_synthesis=tuple(layers),
        linear_stabiliser_synth=stab_synth,
        ups_k_size=int(cfg_args["ups_k_size"]),
        ups_preconcat_k_size=int(cfg_args["ups_preconcat_k_size"]),
        ifce_resolution=ifce_resolution,
        output_feature_ifce=output_feature_ifce,
        latent_resolution=parse_latent_resolution(cfg_args["latent_resolution"], n_pixels),
        hyperlatent_resolution=parse_hyperlatent_resolution(
            cfg_args["hyperlatent_resolution"], n_pixels),
        flag_common_randomness=coolchic_name == "residue" and tune == "wasserstein",
        img_size=img_size,
        final_upsampling_type="nearest" if coolchic_name == "motion" else "bicubic",
        **arm,
    )
