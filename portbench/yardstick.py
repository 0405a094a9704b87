"""The benchmark's arithmetic: configurations, MAC counts, the wavefront
kernel's least time, the chip's published peaks, and the reduction of a
profiler trace to busy time, kernel time, launches and idle gaps.

Nothing here imports the program: the configuration comes from the
frozen copy of its parser (reference/bitparse.py), the MAC counts are a
copy of coolchic_tpu_torch/utils/complexity.py and the bound a copy of
chip_smoke.py:kernel_bound.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

from portbench.reference.bitparse import CoolChicConfig

PB = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
FP32_FLOP_PER_S = 67e12       # CUDA cores, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# Integer operations are priced at the FP32 rate: the data sheet gives no
# int32 CUDA-core rate, so this peak is an assumption.
CORE_OPS_PER_S = FP32_FLOP_PER_S


def card_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable: power.limit not read"


# ---------------------------------------------------------------- configuration
def load_config(name: str) -> dict:
    return json.loads((PB / "configs" / f"{name}.json").read_text())


def _auto_floor(n_pixels: int) -> int:
    return 6 if n_pixels < 1_000_000 else 7 if n_pixels < 3_000_000 else 8


def coolchic_config(op: dict, img_size: tuple[int, int]) -> CoolChicConfig:
    """The intra CoolChicConfig of an operating point's keys (cfg-file
    strings) at an image size."""
    floor = _auto_floor(img_size[0] * img_size[1])

    def res(s, lo):
        if s == "auto":
            return (lo, floor)
        return None if s == "no" else tuple(int(x) for x in s.split("-") if x)

    layers, _, stab = op["layers_synthesis"].partition("/")
    arm, _, arm_stab = op["arm"].partition("/")
    n_ctx, n_hidden = (int(x) for x in arm.split(","))
    ifce = res(op["ifce_resolution"], 0)
    return CoolChicConfig(
        layers_synthesis=tuple(layers.split(",")),
        linear_stabiliser_synth=stab == "stabiliser",
        ups_k_size=int(op["ups_k_size"]),
        ups_preconcat_k_size=int(op["ups_preconcat_k_size"]),
        ifce_resolution=ifce,
        output_feature_ifce=int(op["output_feature_ifce"]) if ifce else 0,
        spatial_context_arm=n_ctx,
        linear_stabiliser_arm=arm_stab == "stabiliser",
        n_hidden_layers_arm=n_hidden,
        latent_resolution=res(op["latent_resolution"], 0),
        hyperlatent_resolution=res(op["hyperlatent_resolution"], 4),
        flag_common_randomness=False,
        img_size=tuple(img_size),
        final_upsampling_type="bicubic")


# ------------------------------------- MAC counts (utils/complexity.py's)
def arm_macs(cfg: CoolChicConfig) -> int:
    c = cfg.total_context_arm
    per_pixel = cfg.n_hidden_layers_arm * c * c + c * 2
    if cfg.linear_stabiliser_arm:
        per_pixel += c * 2
    return per_pixel * sum(h * w for h, w in cfg.size_per_latent)


def ifce_macs(cfg: CoolChicConfig) -> int:
    total = 0
    for i, in_ft in enumerate(cfg.input_features_ifce):
        if in_ft == 0:
            continue
        h, w = cfg.size_per_latent[i + 1 if i + 1 < cfg.n_latent_grids else i]
        total += h * w * in_ft * cfg.output_feature_ifce
    return total


def upsampling_macs(cfg: CoolChicConfig) -> int:
    sizes = [s for s, hyper in zip(cfg.size_per_latent, cfg.flag_is_hyperlatent)
             if not hyper]
    total, n_ch = 0, 1
    for idx in range(len(sizes) - 1, 0, -1):
        h_out, w_out = sizes[idx - 1]
        h_in, w_in = sizes[idx]
        total += n_ch * cfg.ups_k_size * (h_in * 2 * w_in + 2 * h_in * 2 * w_in)
        total += 2 * cfg.ups_preconcat_k_size * h_out * w_out
        n_ch += 1
    return total


def synthesis_macs(cfg: CoolChicConfig) -> int:
    h, w = next(s for s, hyper in zip(cfg.size_per_latent, cfg.flag_is_hyperlatent)
                if not hyper)
    in_ft, total = cfg.input_feature_synthesis, 0
    for out_ft, k, _, _ in cfg.parsed_synthesis:
        total += in_ft * out_ft * k * k * h * w
        in_ft = out_ft
    if cfg.linear_stabiliser_synth:
        total += cfg.input_feature_synthesis * cfg.synthesis_out_ft * h * w
    return total + cfg.synthesis_out_ft ** 2 * h * w


def mac_per_pixel(cfg: CoolChicConfig) -> float:
    n = cfg.img_size[0] * cfg.img_size[1]
    return (arm_macs(cfg) + ifce_macs(cfg) + upsampling_macs(cfg) + synthesis_macs(cfg)) / n


# ---------------------------------- the wavefront kernel's least time
def n_wavefronts(h: int, w: int) -> int:
    return (w - 1) + (h - 1) * max(5, -(-w // 128)) + 1


def kernel_levels(cfg: CoolChicConfig) -> list[int]:
    """The levels coded as 128 streams, which the wavefront kernel decodes."""
    return [i for i, (h, w) in enumerate(cfg.size_per_latent) if h * w >= 1 << 16]


def kernel_bound(h: int, w: int, G: int, n_words: int, n_ifce: int, dim: int,
                 n_hidden: int) -> tuple[float, str, dict]:
    """Least seconds of one launch over G grids of [h, w] (chip_smoke.py's
    kernel_bound, with the stream words counted as the files hold them):
    each input byte read once and each output byte written once at the
    HBM rate, against the integer operations per decoded pixel at the
    CUDA-core rate."""
    n_params = n_hidden * dim * dim + n_hidden * dim + 4 * dim + 4
    n_bytes = 4 * (n_words + G * n_params + G * h * w * n_ifce + G * h * w)
    # per pixel: ARM multiply-adds (2 ops each) plus bias/ReLU/shift, 9
    # evaluations of the integer CDF (32 ops each), quantile and state update
    ops_px = 2 * (n_hidden * dim * dim + 4 * dim) + 3 * n_hidden * dim + 9 * 32 + 10
    n_ops = ops_px * G * h * w
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / CORE_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", {
        "bytes": n_bytes, "ops": n_ops, "serial_wavefronts": n_wavefronts(h, w)}


# ------------------------------------------------------ trace reduction
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_trace(path: Path, window_span: str = "portbench.window") -> dict:
    """A chrome trace of torch.profiler -> busy seconds, kernel seconds by
    name, kernel launches, device ops by time and idle seconds by the
    benchmark's span open on the host, within the `window_span` range
    (the trace_window_s it returns; None in a trace of the card alone)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == window_span and e.get("cat") == "user_annotation"]
    dev_x = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if win:
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    elif dev_x:              # a trace of the card alone: its first to its last op
        w0 = min(e["ts"] for e in dev_x)
        w1 = max(e["ts"] + e["dur"] for e in dev_x)
    else:
        w0 = w1 = 0.0
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
             if e.get("cat") == "user_annotation" and e["name"].startswith("portbench.")
             and e["name"] != window_span]
    dev, kernel_s, op_s, launches = [], {}, {}, 0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        op_s[e["name"]] = op_s.get(e["name"], 0.0) + (b - a) * 1e-6
        if e["cat"] == "kernel":
            launches += 1
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle_by: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "no benchmark span"
        idle_by[name] = idle_by.get(name, 0.0) + (b - a) * 1e-6

    def top(d):
        return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "trace_window_s": (w1 - w0) * 1e-6 if win else None,
            "kernel_s": kernel_s, "launches": launches,
            "breakdown": {"device_ops": top(op_s), "idle_gaps": top(idle_by)}}

