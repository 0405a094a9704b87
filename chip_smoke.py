#!/usr/bin/env python3
"""Smoke run of the PyTorch port (coolchic_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path, the batched decode of `tpu`-profile
bitstreams, at full width: 8 distinct 512x768 hop kodim14 bitstreams of
results/round5/kodak (decoded on the host in the `ref` profile, their
latents re-encoded to the `tpu` profile by the port's own encoder) go
through coolchic_tpu_torch.bitstream.decode.decode_images(device="cuda").

Phases, each fatal on failure:
  1. set-up: versions, card name and power limit, build of both native
     libraries (g++ and nvcc, started together);
  2. the CUDA wavefront kernel against its plain PyTorch version and the
     host C++ decoder, bit for bit: on host-packed inputs, level 0 (512x768,
     IFCE) of one image and level 1 of two different images in one launch;
     then on the main path's own inputs (G = 8, IFCE from the card);
  3. the slice: decode_images on the card, every group on the device path,
     kernel launches counted, grids bit-exact against the host decode, float
     output within 1e-4 of the port's `ref`-profile decode and 8-bit planes
     within one code value;
  4. timing with CUDA events (warm-up, median of 5; the plain version, no
     warm-up, median of 3): batch decode, kernel
     per level at G = 8, kernel and plain version on one level-0 grid, the
     host C++ decode of that grid as a yardstick, and the kernel's bound;
     level 0 at G = 1, 8 and 32; the ablation line: level 0 at G = 8 for
     the team kernel at T = 4 and 8 and the first design (one thread per
     stream, csrc/wavefront_decode_pr1.cu), each in full (bit-exact against
     the main kernel) and with each part stubbed (-DWFD_ABLATE), in us per
     wavefront; the batch decode split into IFCE + shear, kernels and the
     float tail;
  5. the intra encode: phase 3's first frame, written as a .ppm, encoded
     by the port's CLI (coolchic_tpu_torch.cc_encode.main: hop, debug
     recipe, `tpu` profile, --no_rdoq, --device cuda; exit 0 carries its
     own decode-back checks), kernel launches counted; every grid of the
     new file decoded by the kernel equal to the host C++ decode; one
     training step's loss and gradients on the card against the CPU (loss
     within 1e-5 relative, each leaf's gradient within 1e-3 in L2 norm
     relative to the CPU's), and a TF32 run of the step on the card that
     the tolerance must reject; ms per training step (CUDA events, median
     over a window of 20 main-phase steps); seconds per stage, peak
     memory, PSNR and bpp;
  6. RDOQ on the card: (a) rdoq_coolchic on phase 5's checkpoint
     (NN-quantized without RDOQ): seconds per (module, wb) sweep (the card
     synchronised), probes, lanes, host syncs, scalars adjusted, rollbacks,
     peak memory, and the true objective (the `tpu` file written and
     decoded by the port: mse + lambda * 8 * bytes / pixels) before and
     after, which must not worsen; (b) one probe of each scorer (ARM, IFCE,
     synthesis row tiles, upsampling full reconstruction) on the card and
     on the CPU, equal within the CPU tests' bars; (c) the CLI with its
     defaults (RDOQ on) at 512x768 hop, debug recipe, `tpu` profile, on a
     fresh workdir (a workdir holding a checkpoint resumes from it): exit 0,
     kernel launches counted, seconds per stage, archi.txt and the
     encoder, decoder and detailed TSVs parsed, every grid of the new file
     kernel == host C++;
  7. --tune wasserstein through the CLI (the same input, .ppm; common
     randomness, the serial trainer), checked as in 6c but for the grids:
     a common-randomness file decodes on the host path; on its parameters
     one training step's loss and gradients on the card against the CPU
     (phase 5's bar), and ms per serial step over one validation window of
     the debug main phase (CUDA events), with peak memory;
  8. video at full width: a synthetic 3-frame 512x768 yuv420 clip (phase
     3's first frame resampled at a pan of t * (3.25, -1.75) px and a 1 %
     zoom a frame about the centre, bilinear, edges replicated) encoded
     by the CLI as I0 (--no_rdoq), P2 and B1 (RDOQ on) at the inter
     defaults (residue hop, motion mop, warp filter 8), lambda 5e-5,
     debug recipe, `tpu` profile, one workdir; each exit 0 (its decode-back bars),
     seconds per stage, PSNR, bpp and peak memory per frame type;
     decode_video of the file on the card, kernel launches counted, the
     route of each cool-chic's group printed, every grid of both
     cool-chics of P and B equal between the device path and the host
     C++, each motion cool-chic's finest grid coded as 128 streams equal
     between the kernel, its plain version and the host C++, the decoded
     frames' luma within one code value of the encoder's saved frames on
     under 0.1 % of the samples (chroma within two codes, more than one
     off on under 1 %, and the decoder's PSNR within 0.05 dB of the saved
     frame's: the reference's chroma rounding differs between encoder and
     decoder); warp_fn card
     against CPU within 1e-5 (eval and training) and its ms (forward,
     forward + backward); one B training step card against CPU at phase
     5's bar with its TF32 control; ms per P and per B training step; one
     probe of the residue tile scorer and of the motion full scorer, P and
     B, card against CPU; RDOQ of a `--no_rdoq` P frame never worsens its
     bitstream objective;
  9. the batched encode and a GOP wave: (a) phase 3's 8 decoded frames
     through encode_images_batched (hop, lambda 1e-3, debug recipe, `tpu`,
     no RDOQ), the 8 files batch decoded (2 kernel launches, every grid
     kernel == host C++, each decoder PSNR within 0.3 dB of the encoder's),
     ms per training step at G = 8 beside phase 5's n = 1 step, images/s,
     seconds per stage, peak memory; (b) phase 8's clip made 5 frames long,
     I0 resumed from phase 8's checkpoint, P4 and B2 by encode_one_frame,
     (B1, B3) as one encode_wave_group (debug recipe, `tpu`, no RDOQ),
     decode_video of the 5-frame file (10 kernel launches, every grid
     kernel == host C++, each frame within phase 8's bars against the
     encoder's saved frame), ms per step of the G = 2 wave beside phase 8's
     B step, slot 0's first window against the frame stepping alone
     (carried step by step, within 5e-2 * lr), peak memory.

Prints the ablation line, the encode, RDOQ, Wasserstein, video, batched
encode and wave lines, a
{"kernels": [...]} line (launches: the default CLI's, phase 6c; every
path's in launches_by_path), then the card line, and ends with
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA card or outside a checkout of the repo.
"""

from __future__ import annotations

import copy
import glob
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_IMAGES = 8
N_TIMED = 5
# The plain version takes ~30 s a level-0 grid (thousands of eager
# launches) and its time is no yardstick: phase 4 times it once, to keep
# the run's time.
N_TIMED_PLAIN = 1
# H100 SXM peaks (NVIDIA data sheet): HBM
# rate, and the CUDA-core (non-tensor) rate, at which int32 multiply-adds
# issue at most.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# Timing yardsticks of phase 4: (design, team) pairs, and the parts the
# -DWFD_ABLATE bits stub (the first design has no team: 1 thread a stream).
DESIGNS = (("team", 4), ("team", 8), ("first", 1))
# Phase 5: one training step's gradients, card against CPU, worst leaf's
# |diff|_2 / |cpu|_2. Full f32 sits far below it and TF32 above it: the
# phase checks both (the TF32 run is its control). The max-norm is printed,
# not held: a symbol near the 2^-16 probability floor has a large gradient
# whose f32 CDF difference is off by up to 2^-24 / 2^-16 on either device.
STEP_GRAD_TOL = 1e-3
ABLATE_PARTS = (("taps", 1), ("arm", 2), ("div", 4), ("search", 8), ("refill", 16),
                ("barrier", 32))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = N_TIMED, warmup: int = 1) -> float:
    """Median over n runs of fn's device time (CUDA events), after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_bound(h: int, w: int, G: int, R: int, ifce_rows: int, dim: int,
                 n_hidden: int) -> tuple[float, str, dict]:
    """Least time of one wavefront_decode launch: each input byte read once
    and each output byte written once at the HBM rate, against the integer
    operations per decoded pixel at the CUDA-core rate."""
    from coolchic_tpu_torch.ops.wavefront_decode import LANES, n_wavefronts

    D = n_wavefronts(h, w)
    n_params = n_hidden * dim * dim + n_hidden * dim + 4 * dim + 4
    n_bytes = 4 * (R * G * LANES + G * n_params + D * ifce_rows * G * LANES + G * h * w)
    # per pixel: ARM multiply-adds (2 ops each) plus bias/ReLU/shift, 9
    # evaluations of the integer CDF (32 ops each), quantile and state update
    ops_px = (2 * (n_hidden * dim * dim + 4 * dim) + 3 * n_hidden * dim
              + 9 * 32 + 10)
    n_ops = ops_px * G * h * w
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / CORE_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, {"bytes": n_bytes, "ops": n_ops,
                                           "serial_wavefronts": D}


def split_batch_ms(batch) -> dict:
    """DeviceBatch.run's device time by part: the same calls as run(), with
    CUDA events between them; median over N_TIMED runs after a warm-up, ms
    summed over the levels (IFCE context + shear, kernel) and the float tail
    (upsampling, synthesis, resize)."""
    import torch

    from coolchic_tpu_torch.models.synthesis import synthesis_batched
    from coolchic_tpu_torch.models.upsampling import upsampling_batched
    from coolchic_tpu_torch.ops import wavefront_decode as wfd
    from coolchic_tpu_torch.ops.resize import interpolate

    cfg = batch.cfg
    samples: dict[str, list] = {}
    for it in range(N_TIMED + 1):
        events, names = [torch.cuda.Event(enable_timing=True)], []
        events[0].record()

        def mark(name):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            names.append(name)

        decoded = dict(batch.host_grids)
        with torch.no_grad():
            for li, level in enumerate(batch.device_levels):
                tensors, kw = batch.kernel_inputs(li, decoded)
                check(wfd.grid_batch_limit(kw["h"], kw["w"], tensors[5].shape[1],
                                           tensors[0].shape[0], batch.G, batch.device)
                      == batch.G, "the batch does not fit one launch per level")
                mark("ifce_shear")
                decoded[level] = wfd.wavefront_decode(*tensors, **kw)
                mark("kernel")
            syn_grids = [decoded[l].float() for l in range(cfg.n_latent_grids)
                         if not cfg.flag_is_hyperlatent[l]]
            dense = upsampling_batched([m[0] for m in batch.modules], syn_grids)
            syn_out = synthesis_batched([m[1] for m in batch.modules], dense)
            interpolate(syn_out, cfg.img_size, cfg.final_upsampling_type)
            mark("float_tail")
        torch.cuda.synchronize()
        if it == 0:
            continue
        total: dict[str, float] = {}
        for name, a, b in zip(names, events[:-1], events[1:]):
            total[name] = total.get(name, 0.0) + a.elapsed_time(b)
        for name, v in total.items():
            samples.setdefault(name, []).append(v)
    return {name: statistics.median(v) for name, v in samples.items()}


def check_file_grids(out: Path, dev) -> list:
    """Every latent grid of a new `tpu`-profile file decoded by the kernel
    equals the host C++ decode; returns the 128-stream (kernel) levels."""
    import numpy as np

    from coolchic_tpu_torch.bitstream import codec
    from coolchic_tpu_torch.bitstream.decode import _decode_items_batched
    from coolchic_tpu_torch.bitstream.device_decode import _parse_level_blocks
    from coolchic_tpu_torch.bitstream.headers import (
        TPU_PROFILE_MAGIC,
        CoolChicHeader,
        FrameHeader,
        VideoHeader,
    )

    rest = out.read_bytes()
    check(rest.startswith(TPU_PROFILE_MAGIC), f"{out.name} is not tpu-profile")
    rest = rest[len(TPU_PROFILE_MAGIC):]
    _, rest = VideoHeader.read(rest)
    _, rest = FrameHeader.read(rest)
    ch, rest = CoolChicHeader.read(rest)
    bnn, blat = rest[:ch.nn_n_bytes], rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent]
    cfg = ch.to_config()
    blocks = _parse_level_blocks(cfg, blat)
    k_levels = [lv for lv in range(cfg.n_latent_grids) if blocks[lv]["n_streams"] == 128]
    check(k_levels[:2] == [0, 1], f"128-stream levels {k_levels}")
    outputs, routes = _decode_items_batched([(ch, bnn, blat)], dev)
    check(routes[0]["path"] == "device", f"decode-back route {routes}")
    _, host_grids = codec.decode_coolchic_tpu_host(ch, bnn, blat, device=dev)
    for lv in range(cfg.n_latent_grids):
        check(np.array_equal(outputs[0][1][lv], host_grids[lv]),
              f"{out.name} level {lv}: kernel decode != host C++")
    return k_levels


def step_on(d, params, fcfg, tgt, phase, noise, cr_on=None, refs=None):
    """One training step's loss and gradients of `params` (one image,
    numpy) on device d: the phase's quantizer and loss, the given noise
    draws; `cr_on(d)` gives the common-randomness grids on d; `refs`: a
    P/B frame's dense [1, 3, H, W] references (numpy)."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.models.params import tree_from_numpy
    from coolchic_tpu_torch.train.encode import _target_from_frame
    from coolchic_tpu_torch.train.params import tree_leaves, tree_map
    from coolchic_tpu_torch.train.train import PhaseFns

    like = tree_from_numpy(tree_map(lambda x: np.asarray(x)[None], params), d)
    fns = PhaseFns(fcfg, like, phase.quantizer_noise_type, phase.quantizer_type,
                   phase.dist_weight, tuple(phase.betas_model), tuple(phase.betas_latent),
                   phase.precondition_frequency_model, cr=None if cr_on is None else cr_on(d))
    args = (tree_leaves(like), {k: [x.to(d) for x in v] for k, v in noise.items()},
            phase.softround_temperature[0], _target_from_frame(tgt, d),
            torch.full((1,), phase.lmbda, device=d),
            None if refs is None else [torch.as_tensor(r, device=d) for r in refs])
    with torch.no_grad():
        loss = float(fns.loss(*args).loss[0])
    return loss, [None if g is None else g.cpu().double() for g in fns.grads(*args)]


def grad_errors(params, grads, ref):
    """Worst per-leaf |g - ref|_2 / |ref|_2 (and its leaf), worst per-leaf
    max |g - ref| / max |ref|."""
    import numpy as np

    from coolchic_tpu_torch.train.params import tree_flatten_with_path, tree_map

    batched = tree_map(lambda x: np.asarray(x)[None], params)
    worst_l2, worst_max = (0.0, ""), 0.0
    for (path, _), a, b in zip(tree_flatten_with_path(batched), grads, ref):
        if b is None or float(b.abs().max()) == 0.0:
            continue
        worst_l2 = max(worst_l2, (float((a - b).norm() / b.norm()), path))
        worst_max = max(worst_max, float((a - b).abs().max() / b.abs().max()))
    return worst_l2, worst_max


def profile_steps(tag: str, step, n: int = 3) -> dict:
    """What the card does in a training step: kernels and their summed
    device time over n steps (torch.profiler), against the steps' wall
    time; printed under `tag`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0) / n
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    n_kernels = sum(len(v) for v in kernels.values()) / n
    busy_ms = sum(sum(v) for v in kernels.values()) / n
    row = {"kernels_per_step": n_kernels, "kernel_ms_per_step": busy_ms,
           "wall_ms_per_step_profiled": wall_ms}
    if n_kernels:
        top = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:5]
        row["top_kernels_ms_per_step"] = {k[:80]: sum(v) / n for k, v in top}
        print(f"{tag}: {n_kernels:.0f} kernels, {busy_ms:.2f} ms of kernel time per step "
              f"against {wall_ms:.2f} ms wall (card busy {busy_ms / wall_ms:.1%}); top: "
              + "; ".join(f"{k[:60]} {sum(v) / n:.2f} ms" for k, v in top), flush=True)
    else:
        print(f"{tag}: the profiler saw no device activity (not measured)", flush=True)
    return row


def encode_phase(dev, target_frame, workdir: Path) -> dict:
    """Phase 5: the intra encode of one 512x768 frame at hop, `tpu` profile,
    through the port's CLI on the card; the new file's grids decoded by the
    kernel against the host C++ decoder; one training step's loss and
    gradients on the card against the CPU; ms per training step."""
    import numpy as np
    import torch

    from coolchic_tpu_torch import cc_encode
    from coolchic_tpu_torch.bitstream.decode import decode_video
    from coolchic_tpu_torch.io.io import load_frame_data_from_file, save_frame_data_to_file
    from coolchic_tpu_torch.models.params import tree_from_numpy
    from coolchic_tpu_torch.ops import wavefront_decode as wfd
    from coolchic_tpu_torch.train.encode import _target_from_frame
    from coolchic_tpu_torch.train.loss import dist_to_db
    from coolchic_tpu_torch.train.params import WEIGHT, tree_leaves, tree_map
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.train import PhaseFns, TorchNoise, init_opt_state
    from coolchic_tpu_torch.utils.checkpoint import load_frame_encoder

    src, out = workdir / "target.ppm", workdir / "out.cool"
    save_frame_data_to_file(target_frame, str(src))
    n_px = target_frame.n_pixels

    # the encode, as a user runs it; its exit code carries the CLI's own
    # decode-back checks (PSNR within 0.3 dB, rate within 20 %)
    torch.cuda.reset_peak_memory_stats(dev)
    wfd.KERNEL.launches = 0
    t0 = time.time()
    rc_main = cc_encode.main(["-i", str(src), "-o", str(out), "--workdir", str(workdir),
                              "--dec_cfg_residue", "hop", "--recipe", "debug", "--profile",
                              "tpu", "--no_rdoq", "--lmbda", "1e-3", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = wfd.KERNEL.launches
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc_main == 0, f"cc_encode exited {rc_main}")
    check(launches > 0, "the encode's decode-back launched no wavefront_decode kernel")
    stages = json.loads((workdir / "0000-encoder_stages.json").read_text())
    with open(workdir / "0000-results_encoder.tsv") as f:
        head, row = f.read().strip().splitlines()[:2]
    enc = dict(zip(head.split("\t"), row.split("\t")))
    n_bytes = out.stat().st_size
    print(f"[5] cc_encode 512x768 hop tpu --no_rdoq: exit 0 in {wall:.1f} s, {n_bytes} "
          f"bytes, wavefront_decode launches {launches} (decode-back)", flush=True)
    print("[5] stages (EncoderMonitor, s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages["stages_s"].items())
        + f"; {stages['iterations']} candidate-iterations", flush=True)
    print(f"[5] torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)

    # every 128-stream grid of the new file: kernel == host C++
    k_levels = check_file_grids(out, dev)
    print(f"[5] new file: levels {k_levels} are 128-stream grids; every grid kernel "
          f"== host C++", flush=True)

    dec = decode_video(str(out), device=dev)["0"]
    tgt = load_frame_data_from_file(str(src))
    psnr_dec = dist_to_db(float(np.mean(np.square(dec.data - tgt.data))))
    print(f"[5] encoder psnr {float(enc['psnr_db']):.3f} dB, rate {8 * n_bytes / n_px:.4f} "
          f"bpp (latent estimate {float(enc['rate_latent_bpp']):.4f}); decoder psnr "
          f"{psnr_dec:.3f} dB", flush=True)

    # one training step, card against CPU: the encode's own (quantized)
    # parameters, a main-phase step's softround + gaussian noise drawn once;
    # then the card once more with TF32 allowed, as the control that the
    # tolerance rejects what TF32 does
    params, fcfg, _ = load_frame_encoder(str(workdir / "0000-frame_encoder.npz"))
    phase = PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1).training_phases[0]
    temp = phase.softround_temperature[0]
    noise = TorchNoise(torch.Generator().manual_seed(0))(
        "step", fcfg, 1, phase.quantizer_noise_type,
        torch.tensor([phase.noise_parameter[0]]), True)
    batched = tree_map(lambda x: np.asarray(x)[None], params)

    def one_step(d):
        return step_on(d, params, fcfg, tgt, phase, noise)

    l_cpu, g_cpu = one_step(torch.device("cpu"))
    l_dev, g_dev = one_step(dev)
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        _, g_tf32 = one_step(dev)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    (l2, l2_path), mx = grad_errors(params, g_dev, g_cpu)
    (l2_tf32, l2_tf32_path), mx_tf32 = grad_errors(params, g_tf32, g_cpu)
    print(f"[5] one step card vs cpu: loss {l_dev:.8f} vs {l_cpu:.8f}; gradients: worst "
          f"leaf |diff|_2/|cpu|_2 {l2:.2e} ({l2_path}), worst max|diff|/max|cpu| {mx:.2e}; "
          f"TF32 control {l2_tf32:.2e} ({l2_tf32_path}), {mx_tf32:.2e}; tolerance "
          f"{STEP_GRAD_TOL:.0e} on the first", flush=True)
    check(abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu), f"step loss card {l_dev} cpu {l_cpu}")
    check(l2 <= STEP_GRAD_TOL, f"step gradient {l2_path}: card vs cpu {l2:.2e}")
    check(l2_tf32 > STEP_GRAD_TOL, f"the TF32 control passes the tolerance ({l2_tf32:.2e})")

    # ms per training step: a main-phase window at n = 1 on the card
    like = tree_from_numpy(batched, dev)
    fns = PhaseFns(fcfg, like, phase.quantizer_noise_type, phase.quantizer_type,
                   phase.dist_weight, tuple(phase.betas_model), tuple(phase.betas_latent),
                   phase.precondition_frequency_model)
    leaves = tree_leaves(like)
    states = init_opt_state(leaves, fns.groups, fns.hp_weight, fns.hp_latent)
    draw = TorchNoise(torch.Generator(device=dev).manual_seed(1))
    level = torch.full((1,), phase.noise_parameter[0], device=dev)
    target, lmbda, lr = (_target_from_frame(tgt, dev), torch.full((1,), 1e-3, device=dev),
                         torch.tensor(phase.lr, device=dev))
    step_ms = []
    torch.cuda.synchronize()
    t0 = time.time()
    for s in range(21):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        leaves, states = fns.step(leaves, states, draw("step", fcfg, 1, "gaussian", level, True),
                                  temp, lr, target, lmbda, refresh=(s + 1) % fns.pf == 0)
        e1.record()
        step_ms.append((e0, e1))
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.time() - t0) / 21
    step_ms = [a.elapsed_time(b) for a, b in step_ms[1:]]
    n_weight = sum(g == WEIGHT for g in fns.groups)
    print(f"[5] training step (n = 1, 512x768 hop, {len(leaves)} leaves, {n_weight} SOAP): "
          f"{statistics.median(step_ms):.2f} ms median of 20 (CUDA events), host "
          f"{host_ms:.2f} ms per step over 21", flush=True)

    # what the card does in a step
    def one_step():
        nonlocal leaves, states
        leaves, states = fns.step(leaves, states, draw("step", fcfg, 1, "gaussian", level, True),
                                  temp, lr, target, lmbda, refresh=False)
    profile_row = profile_steps("[5] profiled step", one_step)
    return {"launches": launches, "step_ms": statistics.median(step_ms),
            "host_step_ms": host_ms, "step_profile": profile_row,
            "stages_s": stages["stages_s"], "peak_bytes": peak, "psnr_enc":
            float(enc["psnr_db"]), "psnr_dec": psnr_dec, "bpp": 8 * n_bytes / n_px}


def bitstream_objective(params, fcfg, side, frame, lmbda, dev, path: Path) -> dict:
    """The true objective of params: the `tpu`-profile file written, decoded
    by the port (the kernel for the 128-stream levels), mse + lambda * 8 *
    bytes / pixels."""
    import numpy as np

    from coolchic_tpu_torch.bitstream.decode import decode_video
    from coolchic_tpu_torch.bitstream.encode import encode_frame
    from coolchic_tpu_torch.utils.codingstructure import CodingStructure

    payload = encode_frame(params, fcfg, CodingStructure(n_frames=1, intra_pos=[0]), side,
                           is_first_frame=True, profile="tpu")
    path.write_bytes(payload)
    dec = decode_video(str(path), device=dev)["0"]
    mse = float(np.mean(np.square(np.asarray(dec.data, np.float64)
                                  - np.asarray(frame.data, np.float64))))
    bpp = 8 * len(payload) / frame.n_pixels
    return {"objective": mse + lmbda * bpp, "mse": mse, "bpp": bpp, "bytes": len(payload)}


def compare_lanes(card, cpu, n_samples=None) -> dict:
    """The CPU tests' bar (tests/test_torch_rdoq.py): each lane within 1e-5
    relative; a reconstruction scorer's lane above it explained by 8-bit
    flips of under 0.1 % of its samples."""
    import numpy as np

    card, cpu = card.astype(np.float64).ravel(), cpu.astype(np.float64).ravel()
    check(bool(np.isfinite(card).all() and np.isfinite(cpu).all()), "non-finite scores")
    rel = np.abs(card - cpu) / np.abs(cpu)
    off = rel > 1e-5
    flips = 0.0
    if off.any():
        check(n_samples is not None, f"rate scorer lanes differ by {rel.max():.2e}")
        flips = np.ceil(np.abs(card - cpu) * n_samples / ((2 + 1 / 255) / 255))
        check(bool((flips[off] < 1e-3 * n_samples).all()),
              f"scorer lanes differ by {rel.max():.2e} ({flips.max():.0f} flips)")
        flips = float(flips[off].max())
    return {"max_rel": float(rel.max()), "lanes_off": int(off.sum()), "max_flips": flips}


def check_workdir_logs(work: Path) -> dict:
    """archi.txt and the reference-schema encoder / decoder TSVs and the
    detailed log of frame 0 exist and parse; returns the detailed row."""
    check("mac_per_pixel total" in (work / "archi.txt").read_text(), "archi.txt")
    for name in ("results_encoder_ref", "results_decoder"):
        head, row = (work / f"0000-{name}.tsv").read_text().splitlines()
        check(len(head.split()) == len(row.split()) > 5, f"0000-{name}.tsv does not parse")
    head, row = (work / "0000-logs_detailed.tsv").read_text().splitlines()
    detailed = dict(zip(head.split("\t"), row.split("\t")))
    check(len(detailed) == len(row.split("\t")), "0000-logs_detailed.tsv does not parse")
    check(float(detailed["rate_bpp"]) > float(detailed["rate_latent_bpp"]) > 0,
          "logs_detailed rates")
    return detailed


def run_cli(dev, tag: str, argv: list, work: Path, kernel_path: bool = True) -> dict:
    """One `cc_encode` run as a user runs it (its exit code carries the
    decode-back checks): wavefront_decode launches counted from 0, peak
    memory, seconds per stage, the logs parsed, and, on the kernel path,
    every grid of the new file kernel == host C++. A common-randomness file
    decodes on the host path (bitstream/device_decode.py:prepare_batch
    refuses it, as the JAX package's device decode does): kernel_path=False
    holds it to 0 launches instead."""
    import torch

    from coolchic_tpu_torch import cc_encode
    from coolchic_tpu_torch.ops import wavefront_decode as wfd

    out = work / "out.cool"
    torch.cuda.reset_peak_memory_stats(dev)
    wfd.KERNEL.launches = 0
    t0 = time.time()
    rc = cc_encode.main([*argv, "-o", str(out), "--workdir", str(work), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = wfd.KERNEL.launches
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"{tag}: cc_encode exited {rc}")
    check((launches > 0) == kernel_path,
          f"{tag}: the decode-back launched wavefront_decode {launches} times")
    stages = json.loads((work / "0000-encoder_stages.json").read_text())
    detailed = check_workdir_logs(work)
    grids = (f"levels {check_file_grids(out, dev)} kernel == host C++" if kernel_path
             else "host decode path (common randomness)")
    n_bytes = out.stat().st_size
    print(f"[{tag}] cc_encode exit 0 in {wall:.1f} s, {n_bytes} bytes, psnr "
          f"{float(detailed['psnr_db']):.3f} dB, wavefront_decode launches {launches} "
          f"(decode-back); {grids}; archi.txt and the encoder, decoder and detailed TSVs "
          f"parse", flush=True)
    print(f"[{tag}] stages (EncoderMonitor, s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages["stages_s"].items())
        + f"; peak {peak / 2**30:.2f} GiB", flush=True)
    return {"wall_s": wall, "launches": launches, "stages_s": stages["stages_s"],
            "peak_bytes": peak, "bytes": n_bytes, "psnr_db": float(detailed["psnr_db"]),
            "rate_bpp_estimate": float(detailed["rate_bpp"])}


def rdoq_phase(dev, p5: Path, work: Path) -> dict:
    """Phase 6: RDOQ on the card. (a) rdoq_coolchic on phase 5's
    checkpoint (NN-quantized without RDOQ): per sweep seconds, probes,
    lanes, host syncs and scalars adjusted, peak memory, and the true
    objective on the real bitstream before and after (must not worsen);
    (b) one probe of each scorer on the card against the CPU; (c) the CLI
    with its defaults (RDOQ on) on a fresh workdir."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.io.io import load_frame_data_from_file
    from coolchic_tpu_torch.nnquant import rdoq as R
    from coolchic_tpu_torch.utils.checkpoint import load_frame_encoder

    work.mkdir()
    params, fcfg, side = load_frame_encoder(str(p5 / "0000-frame_encoder.npz"))
    cfg = fcfg.cc_cfgs["residue"]
    q_shift, expgol = side["residue"]
    frame = load_frame_data_from_file(str(p5 / "target.ppm"))
    target = np.asarray(frame.data, np.float32)
    lmbda = 1e-3

    # (a) the sweeps on the card, the objective measured on the bitstream
    before = bitstream_objective(params, fcfg, side, frame, lmbda, dev, work / "before.cool")
    expgol_after, log = dict(expgol), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    refined = R.rdoq_coolchic(params["residue"], cfg, q_shift, expgol_after, lmbda,
                              target=target, device=dev, log=log)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for rec in log:
        print(f"[6a] rdoq {rec['module']}.{rec['wb']}: {rec['seconds']:.3f} s, {rec['probes']} "
              f"probes x {rec['chunk']} scalars x {rec['shifts']} shifts ({rec['lanes']} lanes), "
              f"{rec['syncs']} host syncs, {rec['adjusted']}/{rec['n']} adjusted, "
              f"{rec['rollbacks']} rollbacks", flush=True)
    after = bitstream_objective({**params, "residue": refined}, fcfg,
                                {"residue": (q_shift, expgol_after)}, frame, lmbda, dev,
                                work / "after.cool")
    print(f"[6a] rdoq_coolchic 512x768 hop: {wall:.2f} s, {sum(r['probes'] for r in log)} "
          f"probes, {sum(r['syncs'] for r in log)} host syncs; peak "
          f"{peak / 2**30:.2f} GiB ({(peak - base_bytes) / 2**30:.2f} above the start); "
          f"objective on the bitstream {before['objective']:.6e} -> "
          f"{after['objective']:.6e} (mse {before['mse']:.4e} -> {after['mse']:.4e}, "
          f"{before['bytes']} -> {after['bytes']} bytes)", flush=True)
    check(after["objective"] <= before["objective"],
          f"RDOQ worsened the objective: {before} -> {after}")

    # (b) one probe of each scorer, card against CPU, on the same inputs
    cpu = torch.device("cpu")
    probes = {}
    for module in ("arm", "ifce", "synthesis", "upsampling"):
        setups = [R.module_scorers(params["residue"], cfg, module, q_shift, expgol, lmbda,
                                   target, "rgb", 8, d, R._probe_budget_bytes(d))
                  for d in (dev, cpu)]
        shifts, chunk = setups[0][:2]
        flat = R._flat(params["residue"], cfg, module, "weight")
        fb = R._flat(params["residue"], cfg, module, "bias")
        idxs = np.random.default_rng(0).permutation(flat.size)[:chunk]
        q = float(2.0 ** q_shift[(module, "weight")])
        vals = flat[idxs][:, None] + np.asarray(shifts, np.float32)[None, :] * np.float32(q)
        res, secs = [], []
        for d, setup in zip((dev, cpu), setups):
            args = [torch.tensor(a, device=d) for a in (flat, fb, idxs, vals)]
            scorer = setup[3]["weight"]
            if d.type == "cuda":
                scorer(*args)   # the first call builds cuDNN / cuBLAS plans
                torch.cuda.synchronize()
            t0 = time.time()
            res.append(scorer(*args).cpu().numpy())
            secs.append(time.time() - t0)
        n_samples = None if module in ("arm", "ifce") else 3 * frame.n_pixels
        cmp = compare_lanes(res[0], res[1], n_samples)
        probes[module] = {"lanes": int(vals.size), "card_s": secs[0], "cpu_s": secs[1], **cmp}
        print(f"[6b] {module} scorer, one probe of {vals.size} lanes: card {secs[0]:.3f} s, "
              f"cpu {secs[1]:.2f} s; max rel diff {cmp['max_rel']:.2e}, "
              f"{cmp['lanes_off']} lanes above 1e-5 (<= {cmp['max_flips']:.0f} flipped "
              f"samples)", flush=True)

    # (c) the CLI with its defaults: RDOQ on, fresh workdir
    cli = run_cli(dev, "6c", ["-i", str(p5 / "target.ppm"), "--dec_cfg_residue", "hop",
                              "--recipe", "debug", "--profile", "tpu", "--lmbda", "1e-3"],
                  work / "cli")
    check(cli["stages_s"].get("rdoq", 0.0) > 0, "the default CLI ran no RDOQ stage")
    return {"rdoq_s": wall, "sweeps": log, "peak_bytes": peak, "before": before,
            "after": after, "probes": probes, "cli": cli}


def wasserstein_phase(dev, src: Path, work: Path) -> dict:
    """Phase 7: --tune wasserstein through the CLI (512x768 hop, debug
    recipe, .ppm), then on its parameters ms per serial training step
    (CUDA events, one validation window) and one step's loss and gradients
    on the card against the CPU."""
    import torch

    from coolchic_tpu_torch.io.io import load_frame_data_from_file
    from coolchic_tpu_torch.models.frame import frame_cr_grids
    from coolchic_tpu_torch.models.params import tree_from_numpy
    from coolchic_tpu_torch.train.encode import _target_from_frame
    from coolchic_tpu_torch.train.params import tree_leaves, tree_map
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.train import (
        PhaseFns,
        TorchNoise,
        init_opt_state,
        seed_opt_state,
    )
    from coolchic_tpu_torch.utils.checkpoint import load_frame_encoder

    work.mkdir()
    cli = run_cli(dev, "7", ["-i", str(src), "--dec_cfg_residue", "hop", "--recipe", "debug",
                             "--profile", "tpu", "--lmbda", "1e-3", "--tune", "wasserstein"],
                  work / "cli", kernel_path=False)
    params, fcfg, _ = load_frame_encoder(str(work / "cli" / "0000-frame_encoder.npz"))
    check(fcfg.cc_cfgs["residue"].flag_common_randomness, "no common randomness")
    tgt = load_frame_data_from_file(str(src))
    dist = {"mse": 0.2, "wasserstein": 0.8 / 200}   # the CLI's --tune wasserstein weights
    phase = PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1,
                        dist_weight=dist).training_phases[0]

    # one step, card against CPU, the phase-5 bar on the worst leaf
    noise = TorchNoise(torch.Generator().manual_seed(0))(
        "step", fcfg, 1, phase.quantizer_noise_type,
        torch.tensor([phase.noise_parameter[0]]), True)
    t0 = time.time()
    l_cpu, g_cpu = step_on(torch.device("cpu"), params, fcfg, tgt, phase, noise,
                           lambda d: frame_cr_grids(fcfg, d))
    cpu_s = time.time() - t0
    l_dev, g_dev = step_on(dev, params, fcfg, tgt, phase, noise,
                           lambda d: frame_cr_grids(fcfg, d))
    (l2, l2_path), mx = grad_errors(params, g_dev, g_cpu)
    print(f"[7] one Wasserstein step card vs cpu: loss {l_dev:.8f} vs {l_cpu:.8f}; worst "
          f"leaf |diff|_2/|cpu|_2 {l2:.2e} ({l2_path}), worst max|diff|/max|cpu| {mx:.2e} "
          f"(tolerance {STEP_GRAD_TOL:.0e} on the first); the CPU step took {cpu_s:.1f} s",
          flush=True)
    check(abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu), f"step loss card {l_dev} cpu {l_cpu}")
    check(l2 <= STEP_GRAD_TOL, f"step gradient {l2_path}: card vs cpu {l2:.2e}")

    # ms per serial training step: one validation window of the debug main
    # phase (min(freq_valid, max_itr) steps), SOAP seeded as train() does
    like = tree_from_numpy(tree_map(lambda x: x[None], params), dev)
    fns = PhaseFns(fcfg, like, phase.quantizer_noise_type, phase.quantizer_type, dist,
                   tuple(phase.betas_model), tuple(phase.betas_latent),
                   phase.precondition_frequency_model, cr=frame_cr_grids(fcfg, dev))
    leaves = tree_leaves(like)
    target, lmbda = _target_from_frame(tgt, dev), torch.full((1,), 1e-3, device=dev)
    draw = TorchNoise(torch.Generator(device=dev).manual_seed(1))
    level = torch.full((1,), phase.noise_parameter[0], device=dev)
    temp, lr = phase.softround_temperature[0], torch.tensor(phase.lr, device=dev)
    states = init_opt_state(leaves, fns.groups, fns.hp_weight, fns.hp_latent)
    states = seed_opt_state(states, fns.grads(leaves, draw("seed", fcfg, 1, "gaussian", level,
                                                             True), temp, target, lmbda),
                            fns.groups, fns.hp_weight)
    n_steps = min(phase.freq_valid, phase.max_itr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events = []
    t0 = time.time()
    for s in range(n_steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        leaves, states = fns.step(leaves, states, draw("step", fcfg, 1, "gaussian", level, True),
                                  temp, lr, target, lmbda, refresh=(s + 1) % fns.pf == 0)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.time() - t0) / n_steps
    step_ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[7] serial training step (512x768 hop, common randomness, Wasserstein loss): "
          f"{statistics.median(step_ms):.2f} ms median of a window of {n_steps} (CUDA "
          f"events; first {step_ms[0]:.2f} ms), host {host_ms:.2f} ms per step; peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    return {"cli": cli, "step_ms": statistics.median(step_ms), "host_step_ms": host_ms,
            "window_steps": n_steps, "step_peak_bytes": peak, "cpu_step_s": cpu_s,
            "grad_l2": l2, "grad_max": mx}

def synthetic_clip(frame, path: Path, n_frames: int = 3) -> None:
    """A yuv420 8-bit clip from one RGB frame: frame t is the image
    resampled at a pan of t * (3.25, -1.75) px with a 1 % zoom per frame
    about the centre (bilinear, edges replicated), converted by the port's
    rgb2yuv and convert_444_to_420."""
    import numpy as np

    from coolchic_tpu_torch.io.framedata import FrameData
    from coolchic_tpu_torch.io.yuv import convert_444_to_420, rgb2yuv, write_yuv

    img = np.asarray(frame.data, np.float64)[0]
    _, h, w = img.shape
    cy, cx = (h - 1) / 2, (w - 1) / 2
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for t in range(n_frames):
        zoom, dx, dy = 1.01 ** t, 3.25 * t, -1.75 * t
        sy = np.clip(cy + (yy - cy) / zoom + dy, 0, h - 1)
        sx = np.clip(cx + (xx - cx) / zoom + dx, 0, w - 1)
        y0, x0 = np.floor(sy).astype(int), np.floor(sx).astype(int)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        fy, fx = sy - y0, sx - x0
        out = (img[:, y0, x0] * (1 - fy) * (1 - fx) + img[:, y0, x1] * (1 - fy) * fx
               + img[:, y1, x0] * fy * (1 - fx) + img[:, y1, x1] * fy * fx)
        yuv = np.clip(rgb2yuv(out[None].astype(np.float32)), 0.0, 1.0)
        write_yuv(FrameData(8, "yuv420", convert_444_to_420(yuv)), str(path), append=t > 0)


def file_items(path: Path) -> list:
    """Every cool-chic of a multi-frame `tpu`-profile file: [(display
    index, frame type, cc name, (header, nn bytes, latent bytes))]."""
    from coolchic_tpu_torch.bitstream.headers import (
        TPU_PROFILE_MAGIC,
        CoolChicHeader,
        FrameHeader,
        VideoHeader,
    )

    rest = path.read_bytes()
    check(rest.startswith(TPU_PROFILE_MAGIC), f"{path.name} is not tpu-profile")
    vh, rest = VideoHeader.read(rest[len(TPU_PROFILE_MAGIC):])
    out = []
    for _ in range(vh.n_frames):
        fh, rest = FrameHeader.read(rest)
        for name in ["residue"] + (["motion"] if fh.frame_type != "I" else []):
            ch, rest = CoolChicHeader.read(rest)
            bnn, rest = rest[:ch.nn_n_bytes], rest[ch.nn_n_bytes:]
            blat, rest = rest[:ch.n_bytes_latent], rest[ch.n_bytes_latent:]
            out.append((fh.display_index, fh.frame_type, name, (ch, bnn, blat)))
    return out


def planes_mse(dec, ref) -> float:
    import numpy as np

    n = {k: v.size for k, v in ref.data.items()}
    return sum(float(np.sum(np.square(np.asarray(dec.data[k], np.float64)
                                      - np.asarray(ref.data[k], np.float64)))) for k in n) \
        / sum(n.values())


def against_saved_frame(tag: str, decoded: dict, wd: Path, saved_name, originals: list,
                        disp: int) -> dict:
    """A decoded frame against the encoder's own saved frame: luma within
    one code value, on under 0.1 % of the samples. The decoder rounds its
    444 output to 8 bits before the 420 pooling and the encoder pools
    first (the JAX package's and the reference's pipelines, ROADMAP.md
    Queue 3), so a chroma sample is one code apart on a share of the
    samples, and the P/B frames predict from references that differ so:
    chroma within two codes, more than one code apart on under 1 % of the
    samples, and the decoder's PSNR within 0.05 dB of the saved frame's."""
    import numpy as np

    from coolchic_tpu_torch.io.io import load_frame_data_from_file

    saved = load_frame_data_from_file(str(wd / saved_name(disp)))
    rec = {}
    for k, v in saved.data.items():
        d = np.abs(np.round(decoded[str(disp)].data[k] * 255) - np.round(v * 255))
        rec[k] = {"max_codes": float(d.max()), "share_off": float((d > 0).mean()),
                  "share_over_1": float((d > 1).mean())}
    psnr_dec = -10 * np.log10(planes_mse(decoded[str(disp)], originals[disp]))
    psnr_saved = -10 * np.log10(planes_mse(saved, originals[disp]))
    print(f"{tag}{disp}: decoder psnr {psnr_dec:.3f} dB, the encoder's saved frame "
          f"{psnr_saved:.3f} dB; against it per plane (max codes, share of samples off, "
          f"share more than one code off): " + ", ".join(
              f"{k} {r['max_codes']:.0f} {r['share_off']:.2e} {r['share_over_1']:.2e}"
              for k, r in rec.items()), flush=True)
    check(rec["y"]["max_codes"] <= 1 and rec["y"]["share_off"] < 1e-3,
          f"{tag}{disp} luma decode vs the encoder's frame: {rec['y']}")
    check(all(rec[k]["max_codes"] <= 2 and rec[k]["share_over_1"] < 1e-2
              for k in ("u", "v")), f"{tag}{disp} chroma decode vs the encoder's frame: {rec}")
    check(abs(psnr_dec - psnr_saved) <= 0.05,
          f"{tag}{disp} decoder psnr {psnr_dec:.3f} vs the saved frame's {psnr_saved:.3f} dB")
    return {**rec, "psnr_dec": psnr_dec, "psnr_saved": psnr_saved}


def file_grids_on_host(tag: str, path: Path, dev) -> dict:
    """Every grid of every cool-chic of a multi-frame `tpu` file: the
    device path (the kernel on the 128-stream levels) == the host C++;
    returns each cool-chic's kernel levels and grid sizes."""
    import numpy as np

    from coolchic_tpu_torch.bitstream import codec
    from coolchic_tpu_torch.bitstream.decode import _decode_items_batched
    from coolchic_tpu_torch.bitstream.device_decode import _parse_level_blocks

    grid_levels = {}
    for disp, ft, name, item in file_items(path):
        outputs, recs = _decode_items_batched([item], dev)
        _, host = codec.decode_coolchic_tpu_host(*item, device=dev)
        cfg = item[0].to_config()
        for lv in range(cfg.n_latent_grids):
            check(np.array_equal(outputs[0][1][lv], host[lv]),
                  f"frame {disp} {name} level {lv}: device path != host C++")
        blocks = _parse_level_blocks(cfg, item[2])
        k_levels = [lv for lv in range(cfg.n_latent_grids) if blocks[lv]["n_streams"] == 128]
        grid_levels[f"{ft}{disp} {name}"] = {"kernel_levels": k_levels,
                                             "grids": list(cfg.size_per_latent)}
        print(f"{tag} {ft}{disp} {name}: {cfg.n_latent_grids} grids "
              f"{list(cfg.size_per_latent)} == host C++; 128-stream (kernel) levels "
              f"{k_levels}; route {recs[0]['path']}", flush=True)
    return grid_levels


def motion_grid_on_kernel(dev, cc, cfg, q_shift, expgol) -> dict:
    """The motion cool-chic's finest grid coded as 128 streams (the `tpu`
    profile's layout of a grid of 65 536 px or more; at 512x768 the motion
    grids are smaller and decode on the host), then decoded by the CUDA
    kernel, by its plain version and by the host C++: the kernel on the
    motion configuration (latents from level 2, no hyperlatents, IFCE 2-2).
    These launches are not the main path's."""
    import numpy as np

    from coolchic_tpu_torch.bitstream import codec
    from coolchic_tpu_torch.bitstream import rangecoder as rc
    from coolchic_tpu_torch.bitstream.encode import _int_arm_params
    from coolchic_tpu_torch.bitstream.headers import CoolChicHeader
    from coolchic_tpu_torch.core.constants import non_zero_pixel_ctx_index
    from coolchic_tpu_torch.ops import wavefront_decode as wfd

    header = CoolChicHeader.from_config(cfg, nn_q_step_shift=dict(q_shift),
                                        nn_expgol_cnt=dict(expgol),
                                        nn_n_bytes=0, nn_n_bit_pad=0, n_bytes_latent=0)
    nn_int = _int_arm_params(cc, cfg, q_shift)
    arm8 = codec._main_arm_params(nn_int, header, cfg, 1)
    grids = [np.clip(np.round(np.asarray(lat) * cfg.encoder_gain), -64, 63).astype(np.int64)
             for lat in cc["latents"]]
    h, w = cfg.size_per_latent[0]
    ifce = codec._ifce_context_for_grid(nn_int, cfg, header, 0, grids[1:], h, w, model=1)
    ctx_idx = non_zero_pixel_ctx_index(cfg.spatial_context_arm)
    encoders = [rc.RangeEncoder() for _ in range(wfd.LANES)]
    rc.code_grid_streams(encoders, True, h, w, cfg.spatial_context_arm, ifce, arm8, ctx_idx,
                         data=np.ascontiguousarray(grids[0]), model=1)
    words = [np.frombuffer(e.get_bytes(), np.uint32).copy() for e in encoders]
    host = rc.code_grid_streams([rc.RangeDecoder(ws.tobytes()) for ws in words], False, h, w,
                                cfg.spatial_context_arm, ifce, arm8, ctx_idx, model=1)
    job = [{"words": words, "arm8": arm8, "ifce": ifce}]
    n_ifce = cfg.output_feature_ifce if cfg.flag_ifce else 0
    before = wfd.KERNEL.launches
    got = wfd.decode_grids(job, h, w, ctx_idx, n_ifce, device=dev)[0]
    launched = wfd.KERNEL.launches - before
    plain = wfd.decode_grids(job, h, w, ctx_idx, n_ifce, device=dev, plain=True)[0]
    check(launched > 0, "the motion grid did not reach the kernel")
    check(np.array_equal(host, grids[0]), "motion grid: host C++ != the coded grid")
    err = int(np.abs(np.asarray(got) - np.asarray(plain)).max())
    check(err == 0, f"motion grid: kernel != plain (max {err})")
    check(np.array_equal(got, host), "motion grid: kernel != host C++")
    return {"shape": [h, w], "max_abs_err": err, "launches": launched}


def step_ms_inter(dev, params, fcfg, tgt, phase, refs, n: int = 20) -> float:
    """Median device time of n training steps (after one) of one P/B frame
    at n = 1, CUDA events."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.models.params import tree_from_numpy
    from coolchic_tpu_torch.train.encode import _target_from_frame
    from coolchic_tpu_torch.train.params import tree_leaves, tree_map
    from coolchic_tpu_torch.train.train import PhaseFns, TorchNoise, init_opt_state

    like = tree_from_numpy(tree_map(lambda x: np.asarray(x)[None], params), dev)
    fns = PhaseFns(fcfg, like, phase.quantizer_noise_type, phase.quantizer_type,
                   phase.dist_weight, tuple(phase.betas_model), tuple(phase.betas_latent),
                   phase.precondition_frequency_model)
    leaves = tree_leaves(like)
    states = init_opt_state(leaves, fns.groups, fns.hp_weight, fns.hp_latent)
    draw = TorchNoise(torch.Generator(device=dev).manual_seed(1))
    level = torch.full((1,), phase.noise_parameter[0], device=dev)
    target, lmbda = _target_from_frame(tgt, dev), torch.full((1,), 1e-3, device=dev)
    lr, temp = torch.tensor(phase.lr, device=dev), phase.softround_temperature[0]
    refs_d = [torch.as_tensor(r, device=dev) for r in refs]
    events = []
    for s in range(n + 1):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        leaves, states = fns.step(leaves, states, draw("step", fcfg, 1, "gaussian", level, True),
                                  temp, lr, target, lmbda, refresh=(s + 1) % fns.pf == 0,
                                  refs=refs_d)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events[1:])


def video_phase(dev, frame, work: Path) -> dict:
    """Phase 8: the I, P and B frames of a synthetic 512x768 clip through
    the CLI on the card, the file decoded, and the card held against the
    CPU on the warp, a B training step and the P/B RDOQ scorers."""
    import shutil

    import numpy as np
    import torch

    from coolchic_tpu_torch import cc_encode
    from coolchic_tpu_torch.bitstream.decode import decode_frame, decode_video
    from coolchic_tpu_torch.bitstream.encode import encode_frame
    from coolchic_tpu_torch.io.io import load_frame_data_from_file
    from coolchic_tpu_torch.io.yuv import convert_420_to_444
    from coolchic_tpu_torch.models.warp import warp_fn
    from coolchic_tpu_torch.nnquant import rdoq as R
    from coolchic_tpu_torch.ops import wavefront_decode as wfd
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.train import TorchNoise
    from coolchic_tpu_torch.train.video import _rdoq_frame_ctx
    from coolchic_tpu_torch.utils.checkpoint import load_frame_encoder
    from coolchic_tpu_torch.utils.codingstructure import CodingStructure

    work.mkdir()
    h, w = frame.img_size
    clip = work / f"clip_{w}x{h}_60p_yuv420_8b.yuv"
    synthetic_clip(frame, clip)

    def saved_name(disp: int) -> str:   # train/video.py:_decoded_name
        return f"{disp:04d}-decoded_{w}x{h}_yuv420_8b.yuv"
    originals = [load_frame_data_from_file(str(clip), t) for t in range(3)]
    out, wd = work / "out.cool", work / "w"
    cs = CodingStructure(n_frames=3, intra_pos=[0], p_pos=[2])
    # The CLI's decode-back holds the real rate within 20 % of the
    # encoder's estimate, which leaves out the `tpu` profile's per-stream
    # overhead (~2 KB a frame here: 256 streams on levels 0 and 1 of the
    # residue). The clip's B frame is well predicted: at lambda 1e-3 it
    # costs ~4 KB and fails that bar (ROADMAP.md Queue 3), at 5e-5 it does not.
    lmbda = 5e-5
    base = ["-i", str(clip), "-o", str(out), "--workdir", str(wd), "--n_frames", "3",
            "--intra_pos", "0", "--p_pos", "-1", "--recipe", "debug", "--profile", "tpu",
            "--lmbda", str(lmbda), "--device", "cuda"]

    # ------------------------------------------------ the encodes, as a user runs them
    frames = {}
    for coding_idx in range(3):
        f = cs.get_frame_from_coding_order(coding_idx)
        before = out.stat().st_size if out.exists() else 0
        torch.cuda.reset_peak_memory_stats(dev)
        wfd.KERNEL.launches = 0
        t0 = time.time()
        rc = cc_encode.main([*base, "--coding_idx", str(coding_idx)]
                            + (["--no_rdoq"] if f.frame_type == "I" else []))
        torch.cuda.synchronize()
        wall = time.time() - t0
        check(rc == 0, f"cc_encode {f.frame_type}{f.display_order} exited {rc}")
        if f.frame_type == "I":
            shutil.copy(out, work / "i_only.cool")
        stem = f"{f.display_order:04d}"
        stages = json.loads((wd / f"{stem}-encoder_stages.json").read_text())
        head, row = (wd / f"{stem}-logs_detailed.tsv").read_text().splitlines()
        det = dict(zip(head.split("\t"), row.split("\t")))
        n_bytes = out.stat().st_size - before
        rec = {"display_index": f.display_order, "wall_s": wall,
               "launches": wfd.KERNEL.launches, "stages_s": stages["stages_s"],
               "peak_bytes": torch.cuda.max_memory_allocated(dev), "bytes": n_bytes,
               "bpp": 8 * n_bytes / originals[0].n_pixels, "psnr_db": float(det["psnr_db"])}
        for k in ("alpha_mean", "beta_mean", "pred_psnr_db", "dummy_pred_psnr_db"):
            rec[k] = float(det[k])
        frames[f.frame_type] = rec
        print(f"[8] cc_encode {f.frame_type}{f.display_order} 512x768 "
              f"{'intra hop --no_rdoq' if f.frame_type == 'I' else 'residue hop, motion mop'}: "
              f"exit 0 in {wall:.1f} s, {n_bytes} bytes = {rec['bpp']:.4f} bpp, psnr "
              f"{rec['psnr_db']:.3f} dB, wavefront_decode launches {rec['launches']} "
              f"(decode-back), peak {rec['peak_bytes'] / 2**30:.2f} GiB", flush=True)
        print(f"[8] {f.frame_type} stages (s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in stages["stages_s"].items()), flush=True)
        if f.frame_type != "I":
            print(f"[8] {f.frame_type} alpha {rec['alpha_mean']:.3f} beta "
                  f"{rec['beta_mean']:.3f} prediction {rec['pred_psnr_db']:.2f} dB, mean of "
                  f"the references {rec['dummy_pred_psnr_db']:.2f} dB", flush=True)
    gflows = {}
    for ft in ("P", "B"):
        params, fcfg, _ = load_frame_encoder(
            str(wd / f"{frames[ft]['display_index']:04d}-frame_encoder.npz"))
        gflows[ft] = [np.asarray(params[f"global_flow_{i + 1}"]).tolist()
                      for i in range(fcfg.n_refs)]
    print(f"[8] global translations found (dx, dy): {gflows}", flush=True)

    # --------------------------------------------- decode_video of the whole file
    routes = []
    wfd.KERNEL.launches = 0
    t0 = time.time()
    decoded = decode_video(str(out), device=dev, routes=routes)
    torch.cuda.synchronize()
    dec_s, dec_launches = time.time() - t0, wfd.KERNEL.launches
    check(sorted(decoded) == ["0", "1", "2"], f"decoded frames {sorted(decoded)}")
    check(dec_launches > 0, "decode_video launched no wavefront_decode kernel")
    for r in routes:
        print(f"[8] route: frame {r['display_index']} {r['cc']}: {r['path']}"
              + (f" ({r['reason']})" if r["reason"] else ""), flush=True)
    print(f"[8] decode_video I+P+B: {dec_s:.2f} s, wavefront_decode launches {dec_launches}",
          flush=True)

    # every grid of both cool-chics: device path == host C++
    grid_levels = file_grids_on_host("[8]", out, dev)

    # the kernel on the motion configuration: each motion cool-chic's
    # finest grid as 128 streams, kernel == plain == host C++
    motion_grids = {}
    for ft in ("P", "B"):
        params, fcfg, side = load_frame_encoder(
            str(wd / f"{frames[ft]['display_index']:04d}-frame_encoder.npz"))
        motion_grids[ft] = motion_grid_on_kernel(dev, params["motion"], fcfg.cc_cfgs["motion"],
                                                 *side["motion"])
        print(f"[8] {ft} motion grid {motion_grids[ft]['shape']} as 128 streams: kernel == "
              f"plain == host C++ ({motion_grids[ft]['launches']} launch, not on the main "
              f"path)", flush=True)

    code_diff = {ft: against_saved_frame(f"[8] {ft}", decoded, wd, saved_name,
                                         originals, frames[ft]["display_index"])
                 for ft in ("I", "P", "B")}

    # --------------------------------------------- warp_fn card against CPU
    ref0 = torch.as_tensor(convert_420_to_444(decoded["0"].data), dtype=torch.float32)
    rng = np.random.default_rng(0)
    coarse = torch.as_tensor(rng.normal(0, 4, (1, 2, 16, 24)), dtype=torch.float32)
    flow = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                           align_corners=False)
    warp_err = {}
    for training in (False, True):
        a = warp_fn(ref0.to(dev), flow.to(dev), 8, training).cpu()
        b = warp_fn(ref0, flow, 8, training)
        warp_err["train" if training else "eval"] = float((a - b).abs().max())
    check(max(warp_err.values()) <= 1e-5, f"warp_fn card vs cpu {warp_err}")
    x_d, f_d = ref0.to(dev), flow.to(dev)
    fwd_ms = cuda_ms(lambda: warp_fn(x_d, f_d, 8, True), n=20)
    f_g = f_d.clone().requires_grad_()

    def fwd_bwd():
        warp_fn(x_d, f_g, 8, True).sum().backward()
    fb_ms = cuda_ms(fwd_bwd, n=20)
    print(f"[8] warp_fn 512x768 filter 8, card vs cpu max |diff| eval {warp_err['eval']:.2e}, "
          f"training {warp_err['train']:.2e}; {fwd_ms:.3f} ms forward, {fb_ms:.3f} ms forward "
          f"+ backward (CUDA events, median of 20)", flush=True)

    # --------------------------------------------- one B step card vs CPU, ms per step
    phase = PresetDebug(lmbda=lmbda, start_lr=1e-2, itr_main_training=1).training_phases[0]
    steps = {}
    for ft in ("P", "B"):
        disp = frames[ft]["display_index"]
        params, fcfg, _ = load_frame_encoder(str(wd / f"{disp:04d}-frame_encoder.npz"))
        refs = [convert_420_to_444(decoded[str(i)].data).astype(np.float32)
                for i in fcfg.index_references]
        steps[ft] = {"step_ms": step_ms_inter(dev, params, fcfg, originals[disp], phase, refs)}
        if ft == "B":
            noise = TorchNoise(torch.Generator().manual_seed(0))(
                "step", fcfg, 1, phase.quantizer_noise_type,
                torch.tensor([phase.noise_parameter[0]]), True)

            def one_step(d):
                return step_on(d, params, fcfg, originals[disp], phase, noise, refs=refs)
            t0 = time.time()
            l_cpu, g_cpu = one_step(torch.device("cpu"))
            cpu_s = time.time() - t0
            l_dev, g_dev = one_step(dev)
            torch.backends.cudnn.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
            try:
                _, g_tf32 = one_step(dev)
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.set_float32_matmul_precision("highest")
            (l2, l2_path), mx = grad_errors(params, g_dev, g_cpu)
            (l2_tf32, l2_tf32_path), _ = grad_errors(params, g_tf32, g_cpu)
            print(f"[8] one B step card vs cpu: loss {l_dev:.8f} vs {l_cpu:.8f}; worst leaf "
                  f"|diff|_2/|cpu|_2 {l2:.2e} ({l2_path}), max {mx:.2e}; TF32 control "
                  f"{l2_tf32:.2e} ({l2_tf32_path}); tolerance {STEP_GRAD_TOL:.0e}; the CPU "
                  f"step took {cpu_s:.1f} s", flush=True)
            check(abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu), f"B step loss card {l_dev} cpu {l_cpu}")
            check(l2 <= STEP_GRAD_TOL, f"B step gradient {l2_path}: card vs cpu {l2:.2e}")
            check(l2_tf32 > STEP_GRAD_TOL, f"the TF32 control passes ({l2_tf32:.2e})")
            steps[ft].update(grad_l2=l2, grad_max=mx, tf32_l2=l2_tf32, cpu_step_s=cpu_s)
        print(f"[8] {ft} training step (n = 1, 512x768, residue hop + motion mop, filter 8): "
              f"{steps[ft]['step_ms']:.2f} ms median of 20 (CUDA events)", flush=True)

    # --------------------------------------------- RDOQ probes card vs CPU
    cpu = torch.device("cpu")
    probes = {}
    for ft in ("P", "B"):
        disp = frames[ft]["display_index"]
        params, fcfg, side = load_frame_encoder(str(wd / f"{disp:04d}-frame_encoder.npz"))
        refs = [convert_420_to_444(decoded[str(i)].data).astype(np.float32)
                for i in fcfg.index_references]
        target = convert_420_to_444(originals[disp].data)
        for cc in ("residue", "motion"):
            cfg = fcfg.cc_cfgs[cc]
            q_shift, expgol = side[cc]
            setups = [R.module_scorers(
                params[cc], cfg, "synthesis", q_shift, expgol, lmbda, target, "yuv420", 8, d,
                R._probe_budget_bytes(d), frame_type=ft, frame_ctx=_rdoq_frame_ctx(
                    params, fcfg, cc, [torch.as_tensor(r, device=d) for r in refs], None, d))
                for d in (dev, cpu)]
            shifts = setups[0][0]
            flat = R._flat(params[cc], cfg, "synthesis", "weight")
            fb = R._flat(params[cc], cfg, "synthesis", "bias")
            idxs = np.random.default_rng(0).permutation(flat.size)[:2 if cc == "residue" else 1]
            q = float(2.0 ** q_shift[("synthesis", "weight")])
            vals = flat[idxs][:, None] + np.asarray(shifts, np.float32)[None, :] * np.float32(q)
            res, secs = [], []
            for d, setup in zip((dev, cpu), setups):
                args = [torch.tensor(a, device=d) for a in (flat, fb, idxs, vals)]
                if d.type == "cuda":
                    setup[3]["weight"](*args)
                    torch.cuda.synchronize()
                t0 = time.time()
                res.append(setup[3]["weight"](*args).cpu().numpy())
                secs.append(time.time() - t0)
            cmp = compare_lanes(res[0], res[1], int(1.5 * frame.n_pixels))
            kind = "row-tile" if cc == "residue" else "full-resolution"
            probes[f"{ft} {cc}"] = {"scorer": kind, "lanes": int(vals.size), "card_s": secs[0],
                                    "cpu_s": secs[1], **cmp}
            print(f"[8] {ft} {cc} synthesis ({kind} scorer), one probe of {vals.size} lanes: "
                  f"card {secs[0]:.3f} s, cpu {secs[1]:.2f} s; max rel diff "
                  f"{cmp['max_rel']:.2e}, {cmp['lanes_off']} lanes above 1e-5", flush=True)

    # --------------------------------------------- RDOQ of a --no_rdoq P frame
    wp = work / "p_no_rdoq"
    wp.mkdir()
    shutil.copy(wd / saved_name(0), wp)
    shutil.copy(work / "i_only.cool", wp / "out.cool")
    rc = cc_encode.main(["-i", str(clip), "-o", str(wp / "out.cool"), "--workdir", str(wp),
                         "--n_frames", "3", "--intra_pos", "0", "--p_pos", "-1", "--recipe",
                         "debug", "--profile", "tpu", "--lmbda", str(lmbda), "--device", "cuda",
                         "--coding_idx", "1", "--no_rdoq"])
    check(rc == 0, f"cc_encode P --no_rdoq exited {rc}")
    params, fcfg, side = load_frame_encoder(str(wp / "0002-frame_encoder.npz"))
    ref_i = load_frame_data_from_file(str(wd / saved_name(0)))

    def objective(p, sd):
        payload = encode_frame(p, fcfg, cs, sd, is_first_frame=False, profile="tpu")
        dec, _ = decode_frame(payload, [ref_i], profile="tpu", device=dev)
        mse = planes_mse(dec, originals[2])
        return {"objective": mse + lmbda * 8 * len(payload) / frame.n_pixels, "mse": mse,
                "bytes": len(payload)}

    before = objective(params, side)
    refs_d = [torch.as_tensor(convert_420_to_444(ref_i.data).astype(np.float32), device=dev)]
    side_after, log = {}, []
    t0 = time.time()
    for cc in ("residue", "motion"):
        q_shift, expgol = side[cc]
        expgol = dict(expgol)
        fctx = _rdoq_frame_ctx(params, fcfg, cc, refs_d, None, dev)
        params = {**params, cc: R.rdoq_coolchic(
            params[cc], fcfg.cc_cfgs[cc], q_shift, expgol, lmbda,
            target=convert_420_to_444(originals[2].data), frame_type="P",
            frame_data_type="yuv420", bitdepth=8, frame_ctx=fctx, device=dev, log=log)}
        side_after[cc] = (q_shift, expgol)
    rdoq_s = time.time() - t0
    after = objective(params, side_after)
    print(f"[8] RDOQ of the --no_rdoq P frame: {rdoq_s:.2f} s, {sum(r['probes'] for r in log)} "
          f"probes; objective on the bitstream {before['objective']:.6e} -> "
          f"{after['objective']:.6e} (mse {before['mse']:.4e} -> {after['mse']:.4e}, "
          f"{before['bytes']} -> {after['bytes']} bytes)", flush=True)
    check(after["objective"] <= before["objective"],
          f"RDOQ worsened the P objective: {before} -> {after}")

    return {"frames": frames, "global_flows": gflows, "decode_video_s": dec_s,
            "decode_launches": dec_launches, "routes": [
                {k: v for k, v in r.items() if k != "items"} for r in routes],
            "grid_levels": grid_levels, "motion_grids": motion_grids, "code_diff": code_diff,
            "warp_max_err": warp_err,
            "warp_ms": {"forward": fwd_ms, "forward_backward": fb_ms}, "steps": steps,
            "probes": probes, "rdoq_p": {"seconds": rdoq_s, "before": before, "after": after,
                                         "sweeps": log}}


def _sliced(tree, sl: slice):
    """Slots `sl` of the batch axis of nested lists / dicts of tensors."""
    import torch

    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree[sl]
    if isinstance(tree, dict):
        return {k: _sliced(v, sl) for k, v in tree.items()}
    return [_sliced(v, sl) for v in tree]


def _cat(a, b):
    import torch

    if a is None or isinstance(a, torch.Tensor):
        return None if a is None else torch.cat([a, b])
    if isinstance(a, dict):
        return {k: _cat(a[k], b[k]) for k in a}
    return [_cat(x, y) for x, y in zip(a, b)]


def batch_steps(tag: str, dev, params_list, fcfg, targets, phase, refs_list=None,
                n: int = 20, alone_slot0: bool = False) -> dict:
    """n + 1 training steps of the main phase at G = len(params_list), as
    the batched encode and the wave take them (one generator per slot,
    train.SlotNoise), CUDA events around each step; the first is a warm-up.
    With alone_slot0, slot 0 also steps alone at n = 1 with its own
    generator, carried step by step (before each step slot 0 of the batch
    takes the alone run's parameters and SOAP state): the worst coordinate
    between the two after each step, against the carried-state bar of
    5e-2 * lr. Then 3 steps under torch.profiler."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.models.params import tree_from_numpy
    from coolchic_tpu_torch.train.encode import _target_from_frame
    from coolchic_tpu_torch.train.params import tree_leaves, tree_map
    from coolchic_tpu_torch.train.train import PhaseFns, SlotNoise, TorchNoise, init_opt_state

    G = len(params_list)
    stacked = tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *params_list)
    like = tree_from_numpy(stacked, dev)

    def fns_for(like_):
        return PhaseFns(fcfg, like_, phase.quantizer_noise_type, phase.quantizer_type,
                        phase.dist_weight, tuple(phase.betas_model),
                        tuple(phase.betas_latent), phase.precondition_frequency_model)

    fns = fns_for(like)
    leaves = tree_leaves(like)
    states = init_opt_state(leaves, fns.groups, fns.hp_weight, fns.hp_latent)
    tgts = [_target_from_frame(t, dev) for t in targets]
    target = (tree_map(lambda *xs: torch.cat(xs), *tgts) if isinstance(tgts[0], dict)
              else torch.cat(tgts))
    refs = None if refs_list is None else [
        torch.cat([torch.as_tensor(r[j], device=dev) for r in refs_list])
        for j in range(len(refs_list[0]))]
    noise = SlotNoise([torch.Generator(device=dev).manual_seed(7 + i) for i in range(G)])
    level = torch.full((G,), phase.noise_parameter[0], device=dev)
    lmbda = torch.full((G,), phase.lmbda, device=dev)
    lr, temp = torch.tensor(phase.lr, device=dev), phase.softround_temperature[0]
    if alone_slot0:
        first, rest = slice(0, 1), slice(1, None)
        fns1 = fns_for(_sliced(like, first))
        leaves1, states1 = _sliced(leaves, first), _sliced(states, first)
        noise1 = TorchNoise(torch.Generator(device=dev).manual_seed(7))
        target1 = _sliced(target, first)
        refs1 = None if refs is None else [r[:1] for r in refs]
    events, worst = [], []
    for s in range(n + 1):
        refresh = (s + 1) % fns.pf == 0
        if alone_slot0:
            leaves = _cat(leaves1, _sliced(leaves, rest))
            states = _cat(states1, _sliced(states, rest))
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        leaves, states = fns.step(leaves, states, noise("step", fcfg, G, phase.quantizer_noise_type,
                                                        level, fns.need_noise),
                                  temp, lr, target, lmbda, refs, refresh=refresh)
        e1.record()
        events.append((e0, e1))
        if alone_slot0:
            leaves1, states1 = fns1.step(
                leaves1, states1, noise1("step", fcfg, 1, phase.quantizer_noise_type,
                                         level[:1], fns1.need_noise),
                temp, lr, target1, lmbda[:1], refs1, refresh=refresh)
            worst.append(max(float((a[:1] - b).abs().max()) for a, b in zip(leaves, leaves1)))
    torch.cuda.synchronize()
    out = {"step_ms": statistics.median(a.elapsed_time(b) for a, b in events[1:]), "G": G,
           "steps": n}
    if alone_slot0:
        out.update(slot0_vs_alone_worst=max(worst), bar=5e-2 * phase.lr)

    def one_step():
        nonlocal leaves, states
        leaves, states = fns.step(leaves, states, noise("step", fcfg, G,
                                                        phase.quantizer_noise_type, level,
                                                        fns.need_noise),
                                  temp, lr, target, lmbda, refs, refresh=False)
    out["profile"] = profile_steps(f"{tag} profiled step at G = {G}", one_step)
    return out


def batch_encode_phase(dev, frames: list, work: Path, n1_step_ms: float) -> dict:
    """Phase 9a: phase 3's 8 decoded frames through encode_images_batched
    (hop, lambda 1e-3, debug recipe, `tpu`, no RDOQ), the 8 files batch
    decoded through the kernel, each grid kernel == host C++, each decoded
    image's PSNR within 0.3 dB of the encoder's; ms per training step at
    G = 8 beside phase 5's n = 1 step, images/s, seconds per stage, peak
    memory."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.bitstream.decode import decode_images
    from coolchic_tpu_torch.models.frame import FrameConfig, frame_encoder_init
    from coolchic_tpu_torch.models.params import tree_to_numpy
    from coolchic_tpu_torch.ops import wavefront_decode as wfd
    from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
    from coolchic_tpu_torch.train.loss import dist_to_db
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.train import EncoderMonitor
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, \
        intra_operating_points

    work.mkdir()
    G = len(frames)
    cfgs = {"residue": coolchic_config_from_args(intra_operating_points()["hop"],
                                                 frames[0].img_size)}
    preset = PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1)
    paths = [str(work / f"img{k}.cool") for k in range(G)]
    monitor = EncoderMonitor(device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.time()
    res = encode_images_batched(frames, cfgs, preset, paths, seed=0, verbose=False, rdoq=False,
                                profile="tpu", monitor=monitor, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    h, w = frames[0].img_size
    print(f"[9a] encode_images_batched of {G} {h}x{w} images (hop, debug recipe, tpu, no "
          f"RDOQ): {wall:.1f} s = {G / wall:.3f} images/s; peak {peak / 2**30:.2f} GiB; "
          f"{monitor.iterations_counter} slot-iterations", flush=True)
    print("[9a] stages (EncoderMonitor, s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in monitor.phase_time_sec.items()), flush=True)

    wfd.KERNEL.launches = 0
    t0 = time.time()
    decoded, routes = decode_images(paths, device=dev, return_routes=True)
    torch.cuda.synchronize()
    dec_s, launches = time.time() - t0, wfd.KERNEL.launches
    check(all(r["path"] == "device" for r in routes), f"batched files: routes {routes}")
    check(launches == 2, f"decode_images of the {G} batched files: {launches} kernel launches")
    psnr = []
    for k, (r, dec, frame) in enumerate(zip(res, decoded, frames)):
        p_dec = dist_to_db(float(np.mean(np.square(np.asarray(dec.data, np.float64)
                                                   - np.asarray(frame.data, np.float64)))))
        psnr.append({"encoder": r["psnr_db"], "decoder": p_dec, "bytes": r["n_bytes"]})
        check(abs(p_dec - r["psnr_db"]) < 0.3,
              f"image {k}: decoder psnr {p_dec:.3f} vs encoder {r['psnr_db']:.3f} dB")
    k_levels = [check_file_grids(Path(p), dev) for p in paths]
    print(f"[9a] decode_images of the {G} files: {dec_s:.2f} s, routes "
          f"{[(r['path'], r['items']) for r in routes]}, wavefront_decode launches "
          f"{launches}; every grid of every file kernel == host C++ (levels "
          f"{k_levels[0]}); psnr encoder/decoder: " + ", ".join(
              f"{p['encoder']:.3f}/{p['decoder']:.3f}" for p in psnr), flush=True)

    fcfg = FrameConfig(coolchic_cfg=cfgs, frame_type="I", frame_data_type="rgb", bitdepth=8)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = [tree_to_numpy(frame_encoder_init(gen, fcfg, None, device=dev)) for _ in frames]
    torch.cuda.reset_peak_memory_stats(dev)
    steps = batch_steps("[9a]", dev, params, fcfg, frames, preset.training_phases[0])
    step_peak = torch.cuda.max_memory_allocated(dev)
    print(f"[9a] training step at G = {G} ({h}x{w} hop, one generator a slot): "
          f"{steps['step_ms']:.2f} ms median of 20 (CUDA events) against phase 5's n = 1 "
          f"step {n1_step_ms:.2f} ms: {steps['step_ms'] / n1_step_ms:.2f}x the time for "
          f"{G}x the images; peak {step_peak / 2**30:.2f} GiB", flush=True)
    return {"wall_s": wall, "images_per_s": G / wall, "stages_s": monitor.phase_time_sec,
            "peak_bytes": peak, "decode_s": dec_s, "decode_launches": launches,
            "kernel_levels": k_levels[0], "psnr": psnr, "step_ms_G8": steps["step_ms"],
            "step_ms_n1_phase5": n1_step_ms, "step_peak_bytes": step_peak,
            "step_profile": steps["profile"]}


def wave_phase(dev, frame, p8: Path, work: Path, b_step_ms: float) -> dict:
    """Phase 9b: a 5-frame 512x768 clip (frames 0-2 are phase 8's), I0
    resumed from phase 8's checkpoint, P4 and B2 by encode_one_frame, then
    (B1, B3) as one encode_wave_group (residue hop, motion mop, debug
    recipe, `tpu`, no RDOQ); decode_video of the file with its kernel
    launches, every grid kernel == host C++, each frame within phase 8's
    bars against the encoder's saved frame; ms per step of the G = 2 wave
    beside phase 8's B step; slot 0's first window against the same frame
    stepping alone, carried step by step; peak memory."""
    import shutil

    import numpy as np
    import torch

    from coolchic_tpu_torch.bitstream.decode import decode_video
    from coolchic_tpu_torch.io.io import load_frame_data_from_file
    from coolchic_tpu_torch.io.yuv import convert_420_to_444
    from coolchic_tpu_torch.ops import wavefront_decode as wfd
    from coolchic_tpu_torch.parallel.gop import gop_waves
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.video import encode_one_frame, encode_wave_group
    from coolchic_tpu_torch.utils.checkpoint import load_frame_encoder
    from coolchic_tpu_torch.utils.codingstructure import CodingStructure
    from coolchic_tpu_torch.utils.parsecli import motion_operating_points, \
        residue_operating_points

    work.mkdir()
    h, w = frame.img_size
    clip = work / f"clip_{w}x{h}_60p_yuv420_8b.yuv"
    synthetic_clip(frame, clip, n_frames=5)

    def saved_name(disp: int) -> str:   # train/video.py:_decoded_name
        return f"{disp:04d}-decoded_{w}x{h}_yuv420_8b.yuv"
    originals = [load_frame_data_from_file(str(clip), t) for t in range(5)]
    wd = work / "w"
    wd.mkdir()
    shutil.copy(p8 / "w" / "0000-frame_encoder.npz", wd)   # I0: the resume path
    cs = CodingStructure(n_frames=5, intra_pos=[0], p_pos=[4])
    waves = gop_waves(cs)
    check([[f.display_order for f in wv] for wv in waves] == [[0], [4], [2], [1, 3]],
          f"waves {[[f.display_order for f in wv] for wv in waves]}")
    lmbda = 5e-5   # phase 8's: the CLI's rate check there
    preset = PresetDebug(lmbda=lmbda, start_lr=1e-2, itr_main_training=1)
    inter = {"residue": residue_operating_points()["hop"],
             "motion": motion_operating_points()["mop"]}
    kw = dict(seed=0, verbose=False, rdoq=False, profile="tpu", device=dev)
    results, serial_s = {}, {}
    for wave in waves[:3]:
        f = wave[0]
        t0 = time.time()
        results[f.display_order] = encode_one_frame(f, cs, str(clip), str(wd), preset, inter,
                                                    **kw)
        torch.cuda.synchronize()
        serial_s[f"{f.frame_type}{f.display_order}"] = time.time() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    wave_res = encode_wave_group(waves[3], cs, str(clip), str(wd), preset, inter, **kw)
    torch.cuda.synchronize()
    wave_s, wave_peak = time.time() - t0, torch.cuda.max_memory_allocated(dev)
    for f, r in zip(waves[3], wave_res):
        results[f.display_order] = r
    stages = {f"B{f.display_order}": r["monitor"].phase_time_sec
              for f, r in zip(waves[3], wave_res)}
    print(f"[9b] serial I0 (resumed), P4, B2: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in serial_s.items()) + f"; wave (B1, B3): {wave_s:.1f} s, "
        f"peak {wave_peak / 2**30:.2f} GiB", flush=True)
    for k, st in stages.items():
        print(f"[9b] {k} stages (s): " + ", ".join(f"{n} {v:.2f}" for n, v in st.items()),
              flush=True)

    out = work / "clip.cool"
    order = sorted(range(5), key=lambda d: cs.get_frame_from_display_order(d).coding_order)
    out.write_bytes(b"".join(results[d]["payload"] for d in order))
    routes = []
    wfd.KERNEL.launches = 0
    t0 = time.time()
    decoded = decode_video(str(out), device=dev, routes=routes)
    torch.cuda.synchronize()
    dec_s, dec_launches = time.time() - t0, wfd.KERNEL.launches
    check(sorted(decoded) == [str(i) for i in range(5)], f"decoded frames {sorted(decoded)}")
    check(dec_launches == 10, f"decode_video of the 5-frame file: {dec_launches} launches")
    print(f"[9b] decode_video I0 P4 B2 B1 B3 ({out.stat().st_size} bytes): {dec_s:.2f} s, "
          f"wavefront_decode launches {dec_launches}", flush=True)
    grid_levels = file_grids_on_host("[9b]", out, dev)
    code_diff = {f"{results[d]['fcfg'].frame_type}{d}": against_saved_frame(
        f"[9b] {results[d]['fcfg'].frame_type}", decoded, wd, saved_name, originals, d)
        for d in range(5)}

    # ms per step of the G = 2 wave, and slot 0 against B1 stepping alone
    phase = preset.training_phases[0]
    params, refs, tgts, fcfg = [], [], [], None
    for d in (1, 3):
        p, fcfg_d, _ = load_frame_encoder(str(wd / f"{d:04d}-frame_encoder.npz"))
        fcfg = fcfg or fcfg_d
        params.append(p)
        tgts.append(originals[d])
        refs.append([convert_420_to_444(load_frame_data_from_file(
            str(wd / saved_name(i))).data).astype(np.float32)
            for i in fcfg_d.index_references])
    n_win = min(phase.freq_valid, phase.max_itr)
    steps = batch_steps("[9b]", dev, params, fcfg, tgts, phase, refs, n=n_win - 1,
                        alone_slot0=True)
    print(f"[9b] wave training step at G = 2 ({h}x{w}, residue hop + motion mop, filter 8): "
          f"{steps['step_ms']:.2f} ms median of {n_win - 1} (CUDA events) against phase 8's "
          f"B step {b_step_ms:.2f} ms; slot 0's first window ({n_win} steps) against B1 "
          f"alone, carried step by step: worst coordinate {steps['slot0_vs_alone_worst']:.2e} "
          f"(bar {steps['bar']:.0e})", flush=True)
    check(steps["slot0_vs_alone_worst"] <= steps["bar"],
          f"wave slot 0 vs the frame alone: {steps['slot0_vs_alone_worst']:.2e}")
    return {"serial_s": serial_s, "wave_s": wave_s, "wave_peak_bytes": wave_peak,
            "stages_s": stages, "decode_s": dec_s, "decode_launches": dec_launches,
            "routes": [{k: v for k, v in r.items() if k != "items"} for r in routes],
            "grid_levels": grid_levels, "code_diff": code_diff,
            "step_ms_G2": steps["step_ms"], "b_step_ms_phase8": b_step_ms,
            "slot0_vs_alone_worst": steps["slot0_vs_alone_worst"], "bar": steps["bar"],
            "step_profile": steps["profile"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    if not (ROOT / "coolchic_tpu_torch").is_dir():
        fail(f"no coolchic_tpu_torch package beside {Path(__file__).name}: run it "
             "from a checkout of the repo")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from coolchic_tpu_torch.bitstream import codec
    from coolchic_tpu_torch.bitstream import rangecoder as rc
    from coolchic_tpu_torch.bitstream.decode import (
        _decode_items_batched,
        _finish_frame,
        decode_images,
    )
    from coolchic_tpu_torch.bitstream.device_decode import (
        _parse_level_blocks,
        prepare_batch,
    )
    from coolchic_tpu_torch.bitstream.headers import (
        TPU_PROFILE_MAGIC,
        CoolChicHeader,
        FrameHeader,
        VideoHeader,
    )
    from coolchic_tpu_torch.bitstream.nncodec import decode_network
    from coolchic_tpu_torch.core.constants import non_zero_pixel_ctx_index
    from coolchic_tpu_torch.ops import wavefront_decode as wfd

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---------------------------------------------------------------- 1. set-up
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    card = card_line()
    print(card, flush=True)

    files = sorted(glob.glob(str(ROOT / "results/round5/kodak/*.cool")))
    check(len(files) >= N_IMAGES, f"need {N_IMAGES} bitstreams, found {len(files)}")
    files = files[:N_IMAGES]
    rest = Path(files[0]).read_bytes()
    for reader in (VideoHeader, FrameHeader, CoolChicHeader):
        hdr, rest = reader.read(rest)
    arm_dim = hdr.spatial_context_arm + hdr.output_feature_ifce

    def timed_build(fn, *args):
        t0 = time.time()
        fn(*args)
        return time.time() - t0

    # every library of the run, one compiler each, all started together: the
    # main path's kernel, then phase 4's yardsticks (the first design, the
    # other team size, and each with one part stubbed)
    arm_dp = wfd._kernel_dim(arm_dim)
    variants = [(design, team, ab) for design, team in DESIGNS
                for ab in (0,) + tuple(bit for _, bit in ABLATE_PARTS)]
    t0 = time.time()
    with ThreadPoolExecutor(len(variants) + 1) as ex:
        f_rc = ex.submit(timed_build, rc.get_lib)
        f_cu = {v: ex.submit(timed_build, lambda v=v: wfd.KERNEL.lib(
            arm_dp, v[1], _design=v[0], _ablate=v[2])) for v in variants}
        s_rc = f_rc.result()
        s_cu = {v: f.result() for v, f in f_cu.items()}
    print(f"[1] built rangecoder (g++) in {s_rc:.1f} s and wavefront_decode "
          f"(nvcc, sm_90a, ARM width {arm_dim} padded to {arm_dp}, team of "
          f"{wfd.TEAM}) in {s_cu[('team', wfd.TEAM, 0)]:.1f} s, with {len(variants) - 1} "
          f"timing variants; {time.time() - t0:.1f} s together", flush=True)

    # ------------------------------------------- inputs: 8 distinct bitstreams
    imgs = []
    t0 = time.time()
    for path in files:
        rest = Path(path).read_bytes()
        _, rest = VideoHeader.read(rest)
        fh, rest = FrameHeader.read(rest)
        ch, rest = CoolChicHeader.read(rest)
        bnn = rest[:ch.nn_n_bytes]
        blat = rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent]
        cfg = ch.to_config()
        raw_ref, grids = codec.decode_coolchic(ch, bnn, blat, profile="ref", device=dev)
        nn = decode_network(bnn, cfg, ch.nn_q_step_shift, ch.nn_expgol_cnt,
                            ch.nn_n_bit_pad)
        tpu_ch = copy.copy(ch)
        pay = codec.encode_coolchic_latents(tpu_ch, nn, grids, profile="tpu")
        imgs.append({"path": path, "frame": fh, "cfg": cfg, "ch": tpu_ch, "nn": nn,
                     "bnn": bnn, "pay": pay, "raw_ref": raw_ref, "grids": grids})
    cfg = imgs[0]["cfg"]
    check(all(i["cfg"] == cfg for i in imgs), "bitstreams are not one arch group")
    print(f"[inputs] {N_IMAGES} x {cfg.img_size} hop bitstreams: host ref decode "
          f"+ tpu transcode in {time.time() - t0:.1f} s; grids "
          f"{list(cfg.size_per_latent)}", flush=True)

    ctx_idx = non_zero_pixel_ctx_index(cfg.spatial_context_arm)
    n_ifce = cfg.output_feature_ifce if cfg.flag_ifce else 0

    def host_job(img, level):
        h_i, w_i = cfg.size_per_latent[level]
        blocks = _parse_level_blocks(cfg, img["pay"])
        ifce = codec._ifce_context_for_grid(img["nn"], cfg, img["ch"], level,
                                            img["grids"][level + 1:], h_i, w_i,
                                            model=1)
        arm8 = codec._main_arm_params(img["nn"], img["ch"], cfg, 1)
        return {"words": blocks[level]["words"], "arm8": arm8, "ifce": ifce}

    # ------------------------------------ 2. kernel against its plain version
    max_abs_err = 0
    for level, group in ((0, imgs[:1]), (1, imgs[:2])):
        h_i, w_i = cfg.size_per_latent[level]
        check(_parse_level_blocks(cfg, group[0]["pay"])[level]["n_streams"] == 128,
              f"level {level} is not a 128-stream grid")
        jobs = [host_job(img, level) for img in group]
        t0 = time.time()
        got = wfd.decode_grids(jobs, h_i, w_i, ctx_idx, n_ifce, device=dev)
        torch.cuda.synchronize()
        t_k = time.time() - t0
        t0 = time.time()
        plain = wfd.decode_grids(jobs, h_i, w_i, ctx_idx, n_ifce, device=dev, plain=True)
        t_p = time.time() - t0
        for g, (img, job) in enumerate(zip(group, jobs)):
            decs = [rc.RangeDecoder(ws.tobytes()) for ws in job["words"]]
            host = rc.code_grid_streams(decs, False, h_i, w_i, cfg.spatial_context_arm,
                                        job["ifce"], job["arm8"], ctx_idx, model=1)
            err = int(np.abs(got[g] - plain[g]).max())
            max_abs_err = max(max_abs_err, err)
            check(err == 0, f"level {level} grid {g}: kernel != plain (max {err})")
            check(np.array_equal(got[g], host), f"level {level} grid {g}: kernel != host C++")
            check(np.array_equal(host, img["grids"][level]),
                  f"level {level} grid {g}: host C++ != ref-profile grid")
        print(f"[2] level {level} [{h_i}x{w_i}] G={len(group)}, host-packed inputs: "
              f"kernel == plain == host C++; first kernel call {t_k:.2f} s, plain "
              f"{t_p:.1f} s", flush=True)

    # the same at the main path's own shapes and inputs: G = 8, IFCE computed
    # and sheared (int16-packed where certified) on the card
    items = [(img["ch"], img["bnn"], img["pay"]) for img in imgs]
    batch = prepare_batch(items, dev)
    _, grids_dev = batch.run()
    decoded = dict(enumerate(grids_dev))
    level_inputs = {}
    for li, level in enumerate(batch.device_levels):
        tensors, kw = batch.kernel_inputs(li, decoded)
        level_inputs[level] = (tensors, kw)
        got = wfd.wavefront_decode(*tensors, **kw)
        t0 = time.time()
        plain = wfd.wavefront_decode_plain(*tensors, **kw)
        torch.cuda.synchronize()
        t_p = time.time() - t0
        err = int((got - plain).abs().max())
        max_abs_err = max(max_abs_err, err)
        check(err == 0, f"main-path level {level}: kernel != plain (max {err})")
        for g, img in enumerate(imgs):
            check(np.array_equal(got[g].cpu().numpy(), img["grids"][level]),
                  f"main-path level {level} grid {g}: kernel != host decode")
        print(f"[2] level {level} [{kw['h']}x{kw['w']}] G={batch.G}, main-path inputs "
              f"(ifce_packed={kw['ifce_packed']}): kernel == plain == host decode; plain "
              f"{t_p:.1f} s", flush=True)
    check(max_abs_err == 0, "kernel differs from its plain version")

    # --------------------------------------------------------- 3. the slice
    tmp = tempfile.TemporaryDirectory()
    paths = []
    for k, img in enumerate(imgs):
        p = Path(tmp.name) / f"img{k}.cool"
        p.write_bytes(TPU_PROFILE_MAGIC + VideoHeader().to_bytes() + img["frame"].to_bytes()
                      + img["ch"].to_bytes() + img["bnn"] + img["pay"])
        paths.append(str(p))

    wfd.KERNEL.launches = 0
    t0 = time.time()
    frames, routes = decode_images(paths, device=dev, return_routes=True)
    torch.cuda.synchronize()
    t_main = time.time() - t0
    launches = wfd.KERNEL.launches
    check(all(r["path"] == "device" for r in routes), f"not all groups on device: {routes}")
    check(launches > 0, "decode_images launched no wavefront_decode kernel")
    print(f"[3] decode_images: {len(frames)} frames in {t_main:.2f} s (host work "
          f"included), routes {[(r['path'], r['items']) for r in routes]}, "
          f"wavefront_decode launches {launches}", flush=True)

    outputs, _ = _decode_items_batched(items, dev)
    worst_raw = worst_code = 0.0
    for k, (img, (raw, grids), frame) in enumerate(zip(imgs, outputs, frames)):
        check(len(grids) == cfg.n_latent_grids, f"image {k}: {len(grids)} grids")
        for level, (a, b) in enumerate(zip(grids, img["grids"])):
            check(np.array_equal(a, b), f"image {k} level {level}: grid != host decode")
        check(raw.shape == img["raw_ref"].shape == (1, 3, *cfg.img_size),
              f"image {k}: output shape {raw.shape}")
        check(bool(np.isfinite(raw).all()), f"image {k}: non-finite output")
        worst_raw = max(worst_raw, float(np.abs(raw - img["raw_ref"]).max()))
        ref_frame = _finish_frame(img["raw_ref"], img["frame"].bitdepth,
                                  img["frame"].frame_data_type)
        max_dyn = 2 ** img["frame"].bitdepth - 1
        worst_code = max(worst_code, float(np.abs(np.round(frame.data * max_dyn)
                                                  - np.round(ref_frame.data * max_dyn)).max()))
    check(worst_raw <= 1e-4, f"float output differs from ref decode by {worst_raw}")
    check(worst_code <= 1, f"8-bit planes differ by {worst_code} codes")
    print(f"[3] all {N_IMAGES * cfg.n_latent_grids} grids bit-exact vs host decode; "
          f"float max |diff| vs ref-profile decode {worst_raw:.3g} (<= 1e-4); 8-bit "
          f"planes max diff {worst_code:.0f} code", flush=True)

    # ------------------------------------------------------------ 4. timing
    batch_ms = cuda_ms(batch.run)
    mpix = N_IMAGES * cfg.img_size[0] * cfg.img_size[1] / 1e6
    print(f"[4] batch decode (device levels {batch.device_levels}, IFCE, float tail) "
          f"of {N_IMAGES} images: {batch_ms:.2f} ms median of {N_TIMED} = "
          f"{mpix / batch_ms * 1e3:.2f} Mpix/s", flush=True)

    dim = cfg.spatial_context_arm + n_ifce

    def bound_of(tensors, kw):
        return kernel_bound(kw["h"], kw["w"], tensors[0].shape[1], tensors[0].shape[0],
                            tensors[5].shape[1], dim, cfg.n_hidden_layers_arm)

    per_level = []
    for level, (tensors, kw) in level_inputs.items():
        ms = cuda_ms(lambda: wfd.wavefront_decode(*tensors, **kw))
        bound, by, work = bound_of(tensors, kw)
        per_level.append({"level": level, "shape": [kw["h"], kw["w"]], "G": batch.G,
                          "ifce_packed": kw["ifce_packed"], "ms": ms, "bound_ms": bound,
                          "bound_by": by, **work})
        print(f"[4] level {level} [{kw['h']}x{kw['w']}] G={batch.G}: kernel {ms:.3f} ms "
              f"({1e3 * ms / work['serial_wavefronts']:.2f} us per wavefront over "
              f"{work['serial_wavefronts']}), bound {bound:.4f} ms ({by})", flush=True)

    # one level-0 grid (G = 1): kernel, plain version, host C++ yardstick
    tensors, kw = level_inputs[0]
    one = [tensors[0][:, :1].contiguous(), *(t[:1] for t in tensors[1:5]),
           tensors[5][:, :, :1].contiguous()]
    kern1_ms = cuda_ms(lambda: wfd.wavefront_decode(*one, **kw))
    plain1_ms = cuda_ms(lambda: wfd.wavefront_decode_plain(*one, **kw), n=N_TIMED_PLAIN,
                        warmup=0)
    bound1, by1, work1 = bound_of(one, kw)
    job0 = host_job(imgs[0], 0)
    host_times = []
    for _ in range(N_TIMED):
        decs = [rc.RangeDecoder(ws.tobytes()) for ws in job0["words"]]
        t0 = time.perf_counter()
        rc.code_grid_streams(decs, False, kw["h"], kw["w"], cfg.spatial_context_arm,
                             job0["ifce"], job0["arm8"], ctx_idx, model=1)
        host_times.append(1e3 * (time.perf_counter() - t0))
    host_ms = statistics.median(host_times)
    print(f"[4] level 0 G=1: kernel {kern1_ms:.3f} ms, plain {plain1_ms:.1f} ms (median of "
          f"{N_TIMED_PLAIN}), bound {bound1:.4f} ms ({by1}), host C++ {host_ms:.1f} ms (host "
          f"clock); medians of {N_TIMED} but the plain version's", flush=True)

    # level 0 at G = 1, 8, 32: the time stays flat while G <= 132 SMs
    ref0 = wfd.wavefront_decode(*tensors, **kw)
    t32 = [tensors[0].repeat(1, 4, 1), *(t.repeat(4, 1) for t in tensors[1:5]),
           tensors[5].repeat(1, 1, 4, 1)]
    check(torch.equal(wfd.wavefront_decode(*t32, **kw), ref0.repeat(4, 1, 1)),
          "level 0 at G = 32 differs from G = 8 repeated")
    by_g = {1: kern1_ms, batch.G: next(p["ms"] for p in per_level if p["level"] == 0),
            4 * batch.G: cuda_ms(lambda: wfd.wavefront_decode(*t32, **kw))}
    del t32
    print("[4] level 0 kernel by G: " + ", ".join(f"G={g} {ms:.3f} ms" for g, ms in
                                                 by_g.items()), flush=True)

    # ablation on the main path's level-0 inputs (G = 8): each design in
    # full, then with one part stubbed; a part's cost is the time it takes
    # out, in us per wavefront
    D0 = wfd.n_wavefronts(kw["h"], kw["w"])
    taps_t = wfd.KERNEL.taps_tensor(kw["taps"], dev)

    def launch_variant(design, team, ablate):
        words, wtr, btr, stw, stb, ifce = tensors
        out = torch.empty((words.shape[1], kw["h"], kw["w"]), dtype=torch.int32,
                          device=dev)
        wfd.KERNEL.launch(words, wtr, btr, stw, stb, ifce, taps_t, out, h=kw["h"],
                          w=kw["w"], n_spatial=len(kw["taps"]), ifce_rows=ifce.shape[1],
                          ifce_packed=kw["ifce_packed"], dim=dim,
                          n_hidden=len(kw["dims"]) - 1, team=team, _design=design,
                          _ablate=ablate)
        return out

    ablation = {}
    for design, team in DESIGNS:
        name = design if design == "first" else f"team{team}"
        check(torch.equal(launch_variant(design, team, 0), ref0),
              f"{name} design differs from the main kernel at level 0")
        full_ms = cuda_ms(lambda: launch_variant(design, team, 0))
        row = {"level0_g8_ms": full_ms, "full": 1e3 * full_ms / D0}
        for part, bit in ABLATE_PARTS:
            row[part] = 1e3 * (full_ms - cuda_ms(lambda: launch_variant(design, team, bit))) / D0
        ablation[name] = row
    print(json.dumps({"ablation_us_per_wavefront": ablation, "level": 0, "G": batch.G,
                      "wavefronts": D0, "card": card}), flush=True)

    split = split_batch_ms(batch)
    print(f"[4] batch decode split (CUDA events, median of {N_TIMED}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f"; total {sum(split.values()):.3f} ms", flush=True)

    # ------------------------------------------ 5-7. the intra encoder
    with tempfile.TemporaryDirectory() as wd:
        wd = Path(wd)
        (wd / "p5").mkdir()
        enc = encode_phase(dev, frames[0], wd / "p5")
        rdoq = rdoq_phase(dev, wd / "p5", wd / "p6")
        wass = wasserstein_phase(dev, wd / "p5" / "target.ppm", wd / "p7")
        video = video_phase(dev, frames[0], wd / "p8")
        batch_enc = batch_encode_phase(dev, frames, wd / "p9a", enc["step_ms"])
        wave = wave_phase(dev, frames[0], wd / "p8", wd / "p9b",
                          video["steps"]["B"]["step_ms"])

    kernels = [{
        "name": "wavefront_decode",
        "route": "cuda",
        "source": "coolchic_tpu_torch/csrc/wavefront_decode.cu",
        "replaces": "coolchic_tpu/ops/pallas_decode.py:437",
        "launches": rdoq["cli"]["launches"],
        "launches_by_path": {"decode_images": launches, "cc_encode --no_rdoq": enc["launches"],
                             "cc_encode": rdoq["cli"]["launches"],
                             "cc_encode --tune wasserstein": wass["cli"]["launches"],
                             **{f"cc_encode {ft} frame (video)": r["launches"]
                                for ft, r in video["frames"].items()},
                             "decode_video I+P+B": video["decode_launches"],
                             "decode_images of 8 batched encodes": batch_enc["decode_launches"],
                             "decode_video I0 P4 B2 B1 B3 (wave)": wave["decode_launches"]},
        "max_abs_err": max(max_abs_err, *(g["max_abs_err"]
                                          for g in video["motion_grids"].values())),
        "ms": kern1_ms,
        "plain_ms": plain1_ms,
        "bound_ms": bound1,
        "bound_by": by1,
        "library_ms": None,
        "matches_plain": max_abs_err == 0,
        "work": "ms, plain_ms, bound_ms: one 512x768 level-0 grid (G = 1); per_level: "
                "the main path's G = 8 launches",
        "team": wfd.TEAM,
        "host_cpp_ms": host_ms,
        "per_level": per_level,
        "level0_ms_by_G": by_g,
        "first_design_level0_ms": ablation["first"]["level0_g8_ms"],
        "batch_decode_ms": batch_ms,
        "batch_split_ms": split,
        "mpix_per_s": mpix / batch_ms * 1e3,
    }]
    print(json.dumps({"encode_512x768_hop": enc, "card": card}), flush=True)
    print(json.dumps({"rdoq_512x768_hop": rdoq, "card": card}), flush=True)
    print(json.dumps({"wasserstein_512x768_hop": wass, "card": card}), flush=True)
    print(json.dumps({"video_512x768": video, "card": card}), flush=True)
    print(json.dumps({"batch_encode_512x768_hop": batch_enc, "card": card}), flush=True)
    print(json.dumps({"wave_512x768": wave, "card": card}), flush=True)
    tmp.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
