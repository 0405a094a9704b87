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
  4. timing with CUDA events (warm-up, median of 5; the plain version: its
     level-0 call of phase 2, host clock): batch decode, kernel
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
     a common-randomness file decodes on the host path; its checkpoint
     kept under chiprun_out/phase7/; on its parameters one training step
     on the card, on the CPU in f32 and on the CPU in f64, each leaf's
     gradient error against the f64 step printed for the card and the CPU.
     The step's discrete branches, the ARM's hidden ReLUs and the 2^-16
     floor, go either way within f32 rounding of their edge, and one such
     branch can carry a leaf's gradient: so the card's loss is held within
     1e-5 of the f64 step's; the largest rounding of the ARM's
     pre-activations and of the symbols' probabilities on the card within
     WASS_F64_FACTOR times the CPU f32 step's; and the worst leaf of the
     card's step, with every such branch taken as f64 takes it, within
     WASS_F64_FACTOR times the CPU f32 step's worst leaf, forced alike.
     The branches each f32 step flips are printed; ms per
     serial step over one validation window of the debug main phase (CUDA
     events), with peak memory;
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
     B step, the first 20 steps of slot 0's first window against the frame
     stepping alone (carried step by step, within 5e-2 * lr), peak memory;
 10. multi-device on the one card, the mesh (cuda:0, cuda:0): phase 3's
     first frame tiled 4 x 4 (2048x3072, hop); (a) one training step with
     the rows split over 2 space shards against the whole step (loss
     within 1e-5 relative, worst leaf's gradient within STEP_GRAD_TOL),
     a 4-step window (loss within 1e-3 relative, latents within 2e-4), ms
     per step, host ms and peak of both, the IFCE context's ms beside the
     rate's; (b) the decode-side float path on the mesh against the whole
     eval forward (within 2e-5; make_spatial_synthesis's 8-bit image
     within one code); (c) encode_one_frame whole and with the 2-shard mesh
     (60 main steps, no warm-up, `tpu`, no RDOQ): PSNR within 0.1 dB,
     bytes within 5 %, seconds per stage; the sharded file's decode_video
     (launches, routes, each level's route and kernel ms, every grid
     kernel == host C++, the decoder's PSNR within 0.3 dB of the
     encoder's); the CLI's --spatial_shard 2 refused on one card, auto 0;
     (d) 4 of phase 3's frames (hop, debug): make_batched_window over a
     (2, 1) data mesh against a 1-slice mesh from a carried state (every
     coordinate within 5e-2 * lr), ms per step both ways;
     encode_images_batched (`tpu`, no RDOQ) of the 4 over the data mesh
     and of the first 2 alone (the mesh's first 2 files byte for byte
     theirs), PSNR and bytes image by image, the mesh's files decoded
     through the kernel (every grid
     kernel == host C++, PSNR within 0.3 dB); (e) the two-process run,
     both ranks on the card, gloo;
 11. reproducibility at the port's defaults (cuDNN deterministic): (a)
     phase 5's intra CLI run again into a new workdir, (b) phase 8's P2
     encoded again from I0, (c) encode_images_batched of phase 10d's 2
     frames alone at lambda (1e-3, 4e-3) against 10d's batch at (1e-3,
     1e-3), (d) phase 10c's whole 2048x3072 encode again: slot 0's files
     and each pair of files byte-identical, every new file decoded back
     through the kernel (launches counted, every grid kernel == host C++);
     (e) every path that trains (training_paths: the n = 1 I step, P and B
     steps, a G = 8 batched window, a 2048x3072 step on 2 row shards, the
     serial Wasserstein trainer) at the defaults and under
     torch.use_deterministic_algorithms(True), which must raise nothing
     and end on the same parameters, bit for bit;
     (f) ms per training step at n = 1, G = 8 and 2048x3072 whole, with
     cuDNN deterministic and, flipped here only, not.

The whole run prints the ablation line, the encode, RDOQ, Wasserstein,
video, batched encode, wave, multi-device and reproducibility lines, a
{"kernels": [...]} line (launches: the default CLI's, phase 6c; every
path's in launches_by_path), then the card line, and ends with
{"ok": true, "device": {...}}. Exits non-zero, printing no result, without
a CUDA card or outside a checkout of the repo.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import shutil
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
# Phase 7: against an f64 step on the CPU, the card's f32 Wasserstein step
# may be at most this factor further than the CPU's f32 step: on the worst
# leaf, both steps taking the ARM's branches as f64 takes them, and on the
# largest rounding of the ARM's pre-activations and probabilities.
WASS_F64_FACTOR = 10.0
# Phase 5's intra CLI options, beside the input and output (phase 11a too).
INTRA_ARGV = ["--dec_cfg_residue", "hop", "--recipe", "debug", "--profile", "tpu",
              "--no_rdoq", "--lmbda", "1e-3"]
# Phase 8's rate point (video_cli_argv).
VIDEO_LMBDA = 5e-5
# Phase 11: the short phase every path that trains runs (two windows of one
# step after the SOAP seeding, the schedules held).
PATH_PHASE = dict(lmbda=1e-3, lr=1e-2, max_itr=2, freq_valid=1, patience=100000,
                  quantizer_type="softround", quantizer_noise_type="gaussian",
                  softround_temperature=(0.3, 0.3), noise_parameter=(0.25, 0.25),
                  precondition_frequency_model=2)
WASSERSTEIN_WEIGHTS = {"mse": 0.2, "wasserstein": 0.8 / 200}   # the CLI's --tune wasserstein
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

    ch, bnn, blat = file_header(out)
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


def step_on(d, params, fcfg, tgt, phase, noise, cr_on=None, refs=None, dtype=None):
    """One training step's loss and gradients of `params` (one image,
    numpy) on device d: the phase's quantizer and loss, the given noise
    draws; `cr_on(d)` gives the common-randomness grids on d; `refs`: a
    P/B frame's dense [1, 3, H, W] references (numpy). `dtype`
    (torch.float64) runs the whole step at that precision, params, noise,
    target and constants alike; f32 by default."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.models.params import tree_from_numpy
    from coolchic_tpu_torch.train.encode import _target_from_frame
    from coolchic_tpu_torch.train.params import tree_leaves, tree_map
    from coolchic_tpu_torch.train.train import PhaseFns

    dt = dtype or torch.float32
    like = tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                    tree_from_numpy(tree_map(lambda x: np.asarray(x)[None], params), d))
    cr = None if cr_on is None else {k: None if v is None else [g.to(dt) for g in v]
                                     for k, v in cr_on(d).items()}
    fns = PhaseFns(fcfg, like, phase.quantizer_noise_type, phase.quantizer_type,
                   phase.dist_weight, tuple(phase.betas_model), tuple(phase.betas_latent),
                   phase.precondition_frequency_model, cr=cr)
    args = (tree_leaves(like), {k: [x.to(d, dt) for x in v] for k, v in noise.items()},
            phase.softround_temperature[0], tree_map(lambda x: x.to(dt),
                                                     _target_from_frame(tgt, d)),
            torch.full((1,), phase.lmbda, dtype=dt, device=d),
            None if refs is None else [torch.as_tensor(r, device=d).to(dt) for r in refs])
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


def leaf_errors(params, grads, ref) -> dict:
    """{leaf path: |g - ref|_2 / |ref|_2} over the leaves whose reference
    gradient is not zero."""
    import numpy as np

    from coolchic_tpu_torch.train.params import tree_flatten_with_path, tree_map

    batched = tree_map(lambda x: np.asarray(x)[None], params)
    return {path: float((a.double() - b).norm() / b.norm())
            for (path, _), a, b in zip(tree_flatten_with_path(batched), grads, ref)
            if b is not None and float(b.abs().max()) != 0.0}


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
                              *INTRA_ARGV, "--device", "cuda"])
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
        # a quarter of a chunk for the synthesis: at a full chunk its CPU
        # probe is among the script's longest calls, and its time is bounded
        n_idx = max(1, chunk // 4) if module == "synthesis" else chunk
        idxs = np.random.default_rng(0).permutation(flat.size)[:n_idx]
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


def _arm_rate_in(seen: list, branches=None):
    """A stand-in for models/coolchic.py:_arm_rate (the ARM, its
    reparameterization and the rate). Without `branches` it records its
    inputs in `seen`. With `branches` (the hidden ReLUs' on/off masks
    [n_hidden, n_latents, C] and the above-the-floor mask [n_latents] of
    another step) it computes the same function, but every ReLU and the
    2^-16 floor's max take those branches."""
    import torch

    import coolchic_tpu_torch.models.coolchic as ccm
    from coolchic_tpu_torch.core.constants import MIN_PROBA
    from coolchic_tpu_torch.core.laplace import _LOG2, laplace_cdf
    from coolchic_tpu_torch.models.arm import _linear, arm_reparameterize

    arm_rate = ccm._arm_rate

    def run(arm, lat, ctx):
        if branches is None:
            seen.append((arm, lat.detach(), ctx.detach()))
            return arm_rate(arm, lat, ctx)
        relu_on, above = (m.to(ctx.device) for m in branches)
        y = ctx
        for lay, on in zip(arm["layers"][:-1], relu_on):
            y = (_linear(y, lay) + y) * on.to(y.dtype)[None]
        y = _linear(y, arm["layers"][-1])
        if "stabiliser" in arm:
            y = y + _linear(ctx, arm["stabiliser"])
        mu, scale = arm_reparameterize(y)
        p = laplace_cdf(lat + 0.5, mu, scale) - laplace_cdf(lat - 0.5, mu, scale)
        return -torch.log(torch.where(above[None], p, p.new_full((), MIN_PROBA))) / _LOG2

    return run


def _arm_branches(arm, lat, ctx):
    """The ARM's hidden pre-activations [n_hidden, n_latents, C] and each
    symbol's probability before the 2^-16 floor, recomputed from captured
    inputs on their device (models/arm.py:arm_apply's trunk)."""
    import torch

    from coolchic_tpu_torch.core.laplace import laplace_cdf
    from coolchic_tpu_torch.models.arm import _linear, arm_apply, arm_reparameterize

    with torch.no_grad():
        y, pre = ctx, []
        for lay in arm["layers"][:-1]:
            pre.append(_linear(y, lay) + y)
            y = torch.relu(pre[-1])
        mu, scale = arm_reparameterize(arm_apply(arm, ctx))
        p = laplace_cdf(lat + 0.5, mu, scale) - laplace_cdf(lat - 0.5, mu, scale)
    return torch.stack(pre)[:, 0].double().cpu(), p[0].double().cpu()


def wasserstein_step_check(dev, params, fcfg, tgt, phase) -> dict:
    """Phase 7's step check on one image's parameters: one Wasserstein
    training step on the card, on the CPU in f32 and on the CPU in f64,
    with the same noise, then both f32 steps again with the ARM's discrete
    branches (every hidden ReLU, and the 2^-16 floor's max, which splits
    the gradient at equality) taken as the f64 step takes them. A branch
    whose exact argument sits within f32 rounding of its edge goes either
    way on either device, and one symbol's branch can carry a leaf, so
    the gradient is held on the forced steps and the branches by their
    rounding. Holds the card's loss within 1e-5 of the f64 step's; the
    card's largest rounding of the ARM's pre-activations (|z - z64|) and
    of the symbols' probabilities (|p - p64|) within WASS_F64_FACTOR times
    the CPU f32 step's (a branch the card flips lies within it); and the
    forced card step's worst leaf within WASS_F64_FACTOR times the forced
    CPU step's. Prints each leaf's error of the unforced steps, the
    branches each f32 step takes otherwise than f64, and the element of
    the card's worst unforced leaf that carries most of its error."""
    import numpy as np
    import torch

    import coolchic_tpu_torch.models.coolchic as ccm
    from coolchic_tpu_torch.core.constants import MIN_PROBA
    from coolchic_tpu_torch.models.frame import frame_cr_grids
    from coolchic_tpu_torch.train.train import TorchNoise

    noise = TorchNoise(torch.Generator().manual_seed(0))(
        "step", fcfg, 1, phase.quantizer_noise_type,
        torch.tensor([phase.noise_parameter[0]]), True)
    cr_on = lambda d: frame_cr_grids(fcfg, d)   # noqa: E731
    cpu, arm_rate = torch.device("cpu"), ccm._arm_rate
    steps, seconds, seen = {}, {}, {}
    for name, d, dt in (("f64", cpu, torch.float64), ("card", dev, None), ("cpu", cpu, None),
                        ("card, f64's branches", dev, None),
                        ("cpu, f64's branches", cpu, None)):
        seen[name] = []
        if name.endswith("f64's branches"):
            ccm._arm_rate = _arm_rate_in(seen[name], (z64 > 0, p64 > MIN_PROBA))
        else:
            ccm._arm_rate = _arm_rate_in(seen[name])
        t0 = time.time()
        try:
            steps[name] = step_on(d, params, fcfg, tgt, phase, noise, cr_on, dtype=dt)
        finally:
            ccm._arm_rate = arm_rate
        seconds[name] = time.time() - t0
        if name == "f64":
            z64, p64 = _arm_branches(*seen["f64"][0])
    g64 = steps["f64"][1]
    errs = {k: leaf_errors(params, v[1], g64) for k, v in steps.items() if k != "f64"}
    worst = {k: max((v, p) for p, v in e.items()) for k, e in errs.items()}
    (l2, l2_path), mx = grad_errors(params, steps["card"][1], steps["cpu"][1])

    # the branches each f32 step takes otherwise than f64, by symbol (the
    # ARM rates every grid of the unsharded step in one call, in grid
    # order), and each step's largest rounding of the branches' arguments
    shapes = [np.shape(x) for x in params["residue"]["latents"]]
    starts = np.cumsum([0] + [h * w for h, w in shapes])

    def where(i):
        g = int(np.searchsorted(starts, i, side="right") - 1)
        return (g, *divmod(int(i - starts[g]), shapes[g][1]))

    branches, rounding = {}, {}
    for k in ("card", "cpu"):
        z, p = _arm_branches(*seen[k][0])
        rounding[k] = {"z": float((z - z64).abs().max()), "p": float((p - p64).abs().max())}
        relu = [(lay, *where(i), float(z64[lay, i, u]), float(z[lay, i, u]))
                for lay, i, u in torch.nonzero((z > 0) != (z64 > 0)).tolist()]
        floor = [(*where(i), float(p64[i] / MIN_PROBA), float(p[i] / MIN_PROBA))
                 for i in torch.nonzero(((p > MIN_PROBA) != (p64 > MIN_PROBA))
                                        | ((p == MIN_PROBA) != (p64 == MIN_PROBA))).flatten()
                 .tolist()]
        branches[k] = {"relu (layer, grid, row, col, z64, z)": relu,
                       "floor (grid, row, col, p64 / floor, p / floor)": floor}
    # the element of the card's worst leaf that carries most of its error
    kept = [(a, b) for a, b in zip(steps["card"][1], g64)
            if b is not None and float(b.abs().max()) != 0.0]
    card_g, ref_g = kept[list(errs["card"]).index(worst["card"][1])]
    diff = (card_g - ref_g).flatten()
    top = int(diff.abs().argmax())
    top_el = {"index": [int(v) for v in np.unravel_index(top, tuple(ref_g.shape))],
              "share_of_err2": float(diff[top] ** 2 / diff.norm() ** 2),
              "card": float(card_g.flatten()[top]), "f64": float(ref_g.flatten()[top])}
    fc, fp = worst["card, f64's branches"], worst["cpu, f64's branches"]
    ratio, forced_ratio = worst["card"][0] / worst["cpu"][0], fc[0] / fp[0]
    print("[7] per leaf |g - g64|_2/|g64|_2, card / CPU f32: " + "; ".join(
        f"{k} {errs['card'][k]:.2e}/{errs['cpu'][k]:.2e}" for k in errs["card"]), flush=True)
    print(f"[7] one Wasserstein step: loss card {steps['card'][0]:.8f}, CPU f32 "
          f"{steps['cpu'][0]:.8f}, CPU f64 {steps['f64'][0]:.8f}; worst leaf against f64, "
          f"the ARM's ReLUs and floor on f64's branches: card {fc[0]:.2e} ({fc[1]}), CPU f32 "
          f"{fp[0]:.2e} ({fp[1]}), ratio {forced_ratio:.2f} (bar {WASS_F64_FACTOR:g}); on "
          f"their own branches: card {worst['card'][0]:.2e} ({worst['card'][1]}), CPU f32 "
          f"{worst['cpu'][0]:.2e} ({worst['cpu'][1]}), ratio {ratio:.2f}; largest rounding "
          f"of the ARM's pre-activations card {rounding['card']['z']:.2e} / CPU "
          f"{rounding['cpu']['z']:.2e}, of the probabilities {rounding['card']['p']:.2e} / "
          f"{rounding['cpu']['p']:.2e}; the card's worst leaf's top element {top_el}; card "
          f"against CPU f32 {l2:.2e} ({l2_path}), max-norm {mx:.2e}; the CPU steps took "
          f"{seconds['cpu']:.1f} s (f32) and {seconds['f64']:.1f} s (f64)", flush=True)
    print(f"[7] the ARM's branches taken otherwise than f64: card {branches['card']}; CPU f32 "
          f"{branches['cpu']}", flush=True)
    check(abs(steps["card"][0] - steps["f64"][0]) <= 1e-5 * abs(steps["f64"][0]),
          f"step loss card {steps['card'][0]} f64 {steps['f64'][0]}")
    for k, what in (("z", "the ARM's pre-activations"), ("p", "the symbols' probabilities")):
        check(rounding["card"][k] <= WASS_F64_FACTOR * rounding["cpu"][k],
              f"rounding of {what}: card {rounding['card'][k]:.2e} from the f64 step, more "
              f"than {WASS_F64_FACTOR:g} x the CPU f32 step's {rounding['cpu'][k]:.2e}")
    check(fc[0] <= WASS_F64_FACTOR * fp[0],
          f"step gradient on f64's branches {fc[1]}: card {fc[0]:.2e} from the f64 step, "
          f"more than {WASS_F64_FACTOR:g} x the CPU f32 step's {fp[0]:.2e}")
    return {"cpu_step_s": seconds["cpu"], "f64_step_s": seconds["f64"], "grad_l2": l2,
            "grad_max": mx, "f64_worst": worst, "f64_ratio": ratio,
            "f64_forced_ratio": forced_ratio, "rounding": rounding, "branches": branches,
            "worst_leaf_top": top_el, "f64_leaf_errors": errs}


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

    # The encode's checkpoint is kept: the step below is computed from it.
    keep = ROOT / "chiprun_out" / "phase7"
    keep.mkdir(parents=True, exist_ok=True)
    kept = keep / f"frame_encoder_{time.strftime('%Y%m%d-%H%M%S')}.npz"
    shutil.copy(work / "cli" / "0000-frame_encoder.npz", kept)

    step = wasserstein_step_check(dev, params, fcfg, tgt, phase)
    print(f"[7] checkpoint kept as {kept.relative_to(ROOT)}", flush=True)

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
            "window_steps": n_steps, "step_peak_bytes": peak, **step}

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
    """Every cool-chic of a multi-frame `tpu`-profile file, or of the
    frames it holds so far: [(display index, frame type, cc name, (header,
    nn bytes, latent bytes))]."""
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
        if not rest:
            break
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


def video_cli_argv(clip: Path, out: Path, wd: Path) -> list:
    """Phase 8's CLI arguments but --coding_idx and --no_rdoq. The CLI's
    decode-back holds the real rate within 20 % of the encoder's estimate,
    which leaves out the `tpu` profile's per-stream overhead (~2 KB a frame
    here: 256 streams on levels 0 and 1 of the residue). The clip's B frame
    is well predicted: at lambda 1e-3 it costs ~4 KB and fails that bar
    (ROADMAP.md Queue 3), at 5e-5 it does not."""
    return ["-i", str(clip), "-o", str(out), "--workdir", str(wd), "--n_frames", "3",
            "--intra_pos", "0", "--p_pos", "-1", "--recipe", "debug", "--profile", "tpu",
            "--lmbda", str(VIDEO_LMBDA), "--device", "cuda"]


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
    lmbda = VIDEO_LMBDA
    base = video_cli_argv(clip, out, wd)

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
        if f.frame_type != "B":   # the file as it stands after I0, after P2
            shutil.copy(out, work / f"{'i' if f.frame_type == 'I' else 'ip'}_only.cool")
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
    rc = cc_encode.main([*video_cli_argv(clip, wp / "out.cool", wp), "--coding_idx", "1",
                         "--no_rdoq"])
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
    beside phase 8's B step; the first 20 steps of slot 0's first window
    against the same frame stepping alone, carried step by step; peak
    memory."""
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
    n_win = min(phase.freq_valid, phase.max_itr, 20)   # 20 steps, to keep the script's time
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



def file_header(path: Path):
    """(cool-chic header, nn bytes, latent bytes) of a one-frame `tpu` file."""
    from coolchic_tpu_torch.bitstream.headers import (
        TPU_PROFILE_MAGIC,
        CoolChicHeader,
        FrameHeader,
        VideoHeader,
    )

    rest = path.read_bytes()
    check(rest.startswith(TPU_PROFILE_MAGIC), f"{path.name} is not tpu-profile")
    rest = rest[len(TPU_PROFILE_MAGIC):]
    _, rest = VideoHeader.read(rest)
    _, rest = FrameHeader.read(rest)
    ch, rest = CoolChicHeader.read(rest)
    return ch, rest[:ch.nn_n_bytes], rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent]


def level_routes(path: Path, dev) -> list:
    """Each latent grid of a `tpu` file: its streams, its route (the kernel
    or the host C++) and, for a 128-stream grid the kernel does not take,
    why; the kernel's ms on each level it takes (CUDA events, median)."""
    from coolchic_tpu_torch.bitstream.device_decode import _parse_level_blocks, prepare_batch
    from coolchic_tpu_torch.ops import wavefront_decode as wfd

    ch, bnn, blat = file_header(path)
    cfg = ch.to_config()
    blocks = _parse_level_blocks(cfg, blat)
    batch = prepare_batch([(ch, bnn, blat)], dev)
    _, grids = batch.run()
    decoded = dict(enumerate(grids))
    dim = cfg.spatial_context_arm + (cfg.output_feature_ifce if cfg.flag_ifce else 0)
    timed = {}
    for li, level in enumerate(batch.device_levels):
        tensors, kw = batch.kernel_inputs(li, decoded)
        timed[level] = (cuda_ms(lambda: wfd.wavefront_decode(*tensors, **kw)),
                        wfd.n_wavefronts(kw["h"], kw["w"]))
    out = []
    for level, (h, w) in enumerate(cfg.size_per_latent):
        row = {"level": level, "shape": [h, w], "streams": blocks[level]["n_streams"],
               "route": "kernel" if level in batch.device_levels else "host C++"}
        if level in timed:
            row.update(kernel_ms=timed[level][0], wavefronts=timed[level][1],
                       step=wfd.tpu_wavefront_step(w))
        elif row["streams"] == wfd.LANES:
            row["why"] = ("raster order (w <= 9)" if w <= wfd.MASK else
                          "ARM too wide" if dim > wfd.MAX_ARM_DIM else
                          f"shared memory {wfd.kernel_smem_bytes(w, dim, cfg.n_hidden_layers_arm)}"
                          f" B > {wfd.SMEM_LIMIT_BYTES}" if not wfd.kernel_eligible(
                              h, w, dim, cfg.n_hidden_layers_arm)
                          else "a coarser level is on the host")
        out.append(row)
    return out


def main_only_preset(steps: int = 60, freq_valid: int = 20):
    """Phase 10c's preset: no warm-up, one main phase of `steps` (softround,
    gaussian noise, held temperature and noise), as tests/test_spatial_cli.py's
    TinyPreset at a longer budget."""
    from coolchic_tpu_torch.train.presets import Preset, TrainerPhase, Warmup

    class MainOnly(Preset):
        def __post_init__(self):
            self.preset_name = "phase10"
            self.training_phases = [TrainerPhase(
                lr=self.start_lr, max_itr=steps, freq_valid=freq_valid,
                quantizer_type="softround", quantizer_noise_type="gaussian",
                softround_temperature=(0.3, 0.3), noise_parameter=(0.25, 0.25),
                lmbda=self.lmbda)]
            self.warmup = Warmup([])

    return MainOnly(lmbda=1e-3, start_lr=1e-2, itr_main_training=steps)


def training_paths(dev, images, big) -> dict:
    """Every path of the port that trains, each as a short run through its
    own entry point: {name: fn() -> the parameters it ends on (tensors)}.
    Each fn seeds everything it draws, so two calls compute the same thing
    unless an op of the path is not deterministic. `images` [G, 3, H, W]
    in [0, 1] (numpy): slot 0 is the target of the I, P, B and Wasserstein
    runs, the G slots the batched window's; `big` [1, 3, H2, W2] is split
    over 2 row shards of a mesh that names `dev` twice. Runs on any device
    (the tests run it on the CPU at small crops)."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.models.frame import FrameConfig, frame_cr_grids, frame_encoder_init
    from coolchic_tpu_torch.parallel.batch import (
        batched_init,
        make_batched_window,
        make_mesh,
        phase_key,
    )
    from coolchic_tpu_torch.parallel.encode_batch import _batched_phase
    from coolchic_tpu_torch.parallel.spatial import make_spatial_train
    from coolchic_tpu_torch.train.params import tree_leaves
    from coolchic_tpu_torch.train.presets import TrainerPhase
    from coolchic_tpu_torch.train.train import EncoderMonitor, SlotNoise, TorchNoise, train
    from coolchic_tpu_torch.utils.parsecli import (
        coolchic_config_from_args,
        intra_operating_points,
        motion_operating_points,
        residue_operating_points,
    )

    G, _, H, W = images.shape
    phase = TrainerPhase(**PATH_PHASE)
    tg = torch.as_tensor(np.asarray(images, np.float32), device=dev)

    def gens(n, seed=40):
        return [torch.Generator(device=dev).manual_seed(seed + i) for i in range(n)]

    def intra(size, tune="mse"):
        return FrameConfig(coolchic_cfg={"residue": coolchic_config_from_args(
            intra_operating_points()["hop"], size, tune=tune)})

    def i_step():
        params, _ = batched_init(intra((H, W)), phase, 1, seed=0, device=dev)
        best, loss = _batched_phase(params, tg[:1], intra((H, W)), phase,
                                    EncoderMonitor(device=dev), False,
                                    noise_source=SlotNoise(gens(1)))
        return tree_leaves(best) + [loss]

    def inter_step(ft):
        # display order and references as in a 3-frame I0 P2 B1 GOP; the
        # references are the target shifted by a few pixels
        disp, ref_idx = {"P": (2, (0,)), "B": (1, (0, 2))}[ft]
        fcfg = FrameConfig(coolchic_cfg={
            "residue": coolchic_config_from_args(residue_operating_points()["hop"], (H, W),
                                                 coolchic_name="residue", frame_type=ft),
            "motion": coolchic_config_from_args(motion_operating_points()["mop"], (H, W),
                                                coolchic_name="motion", frame_type=ft)},
            frame_type=ft, frame_data_type="yuv420", index_references=ref_idx,
            frame_display_index=disp)
        x = tg[:1]
        target = {"y": x[:, :1], "u": x[:, 1:2, ::2, ::2].contiguous(),
                  "v": x[:, 2:3, ::2, ::2].contiguous()}
        refs = [torch.roll(x, (2 * r - 1, 3 - r), dims=(-2, -1)) for r in ref_idx]
        params, _ = batched_init(fcfg, phase, 1, seed=0, device=dev)
        best, loss = _batched_phase(params, target, fcfg, phase, EncoderMonitor(device=dev),
                                    False, noise_source=SlotNoise(gens(1)), refs_b=refs)
        return tree_leaves(best) + [loss]

    def batched_window():
        params, opt = batched_init(intra((H, W)), phase, G, seed=0, device=dev)
        params, _, _ = make_batched_window(intra((H, W)), phase_key(phase), 2,
                                           make_mesh(devices=[dev]))(
            params, opt, gens(G), phase.lr, 0.3, 0.25, tg)
        return tree_leaves(params)

    def spatial_step():
        fcfg = intra(tuple(big.shape[-2:]))
        window, _, prepare = make_spatial_train(fcfg, phase_key(phase),
                                                make_mesh(devices=[dev, dev], space=2), 2)
        params = frame_encoder_init(torch.Generator(device=dev).manual_seed(0), fcfg,
                                    device=dev)
        params, opt, target, key = prepare(params, big, seed=3)
        return tree_leaves(window(params, opt, key, target, phase.lr, 0.3, 0.25)[0])

    def wasserstein_step():
        fcfg = intra((H, W), "wasserstein")
        params = frame_encoder_init(torch.Generator(device=dev).manual_seed(0), fcfg,
                                    device=dev)
        best = train(params, fcfg, tg[:1],
                     TrainerPhase(**{**PATH_PHASE, "dist_weight": WASSERSTEIN_WEIGHTS}),
                     noise_source=TorchNoise(gens(1)[0]), cr=frame_cr_grids(fcfg, dev))
        return tree_leaves(best)

    return {"I step (_batched_phase, n = 1)": i_step,
            "P step (_batched_phase, refs)": lambda: inter_step("P"),
            "B step (_batched_phase, refs)": lambda: inter_step("B"),
            f"batched window (make_batched_window, G = {G})": batched_window,
            f"{big.shape[-2]}x{big.shape[-1]} step on 2 row shards (make_spatial_train)":
                spatial_step,
            "serial Wasserstein step (train)": wasserstein_step}


def data_mesh_phase(dev, four: list, work: Path) -> dict:
    """Phase 10d: the data mesh (cuda:0, cuda:0) over 4 512x768 frames;
    make_batched_window split 2 + 2 against unsplit from a carried state,
    and encode_images_batched over the mesh and of the first 2 alone."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.bitstream.decode import decode_images
    from coolchic_tpu_torch.models.frame import FrameConfig
    from coolchic_tpu_torch.ops import wavefront_decode as wfd
    from coolchic_tpu_torch.parallel.batch import (
        batched_init,
        make_batched_window,
        make_mesh,
        phase_key,
    )
    from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
    from coolchic_tpu_torch.train.loss import dist_to_db
    from coolchic_tpu_torch.train.params import tree_leaves
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.train import EncoderMonitor
    from coolchic_tpu_torch.utils.parsecli import (
        coolchic_config_from_args,
        intra_operating_points,
    )

    work.mkdir(parents=True, exist_ok=True)
    data_mesh = make_mesh(devices=[dev, dev], space=1)
    one_slice = make_mesh(devices=[dev], space=1)
    cfgs = {"residue": coolchic_config_from_args(intra_operating_points()["hop"],
                                                 four[0].img_size)}
    fcfg4 = FrameConfig(coolchic_cfg=cfgs)
    preset = PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1)
    phase = preset.training_phases[0]
    tg4 = torch.as_tensor(np.concatenate([np.asarray(f.data, np.float32) for f in four]),
                          device=dev)
    args = (phase.lr, phase.softround_temperature[0], phase.noise_parameter[0], tg4)
    n_win = 10

    def gens(seed):
        return [torch.Generator(device=dev).manual_seed(seed + i) for i in range(4)]

    # make_batched_window from a carried state (one window of the 4 slots
    # from batched_init): ms per step split 2 + 2 and unsplit, each timed on
    # its second call; each data slice's chunk against its own 2 slots
    # alone on a 1-slice mesh, which compute at the chunk's batch size
    # (1e-6, as tests/test_torch_batch_mesh.py); the split against the
    # unsplit 4 is reported, not held: a batch of 2 rounds otherwise than a
    # batch of 4 on the card, and SOAP's normalized update in a carried
    # eigenbasis turns that rounding into up to ~1e-2 in a window.
    p4, o4 = batched_init(fcfg4, phase, 4, seed=0, device=dev)
    p4, o4, _ = make_batched_window(fcfg4, phase_key(phase), n_win, one_slice)(
        p4, o4, gens(20), *args)

    def worst(x, y):
        return max(float((u - v).abs().max()) for u, v in zip(tree_leaves(x), tree_leaves(y)))

    win, ms_d = {}, {}
    for name, m in (("unsplit", one_slice), ("split", data_mesh)):
        window = make_batched_window(fcfg4, phase_key(phase), n_win, m)
        win[name] = []
        for _ in range(2):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            win[name].append(window(p4, o4, gens(40), *args)[0])
            e1.record()
            torch.cuda.synchronize()
        ms_d[name] = e0.elapsed_time(e1) / n_win
    split = win["split"][1]
    spread = {"unsplit run to run": worst(*win["unsplit"]),
              "split run to run": worst(*win["split"]),
              "split against unsplit": worst(split, win["unsplit"][1])}
    worst_d = 0.0
    for a, b in ((0, 2), (2, 4)):
        alone = make_batched_window(fcfg4, phase_key(phase), n_win, one_slice)(
            _sliced(p4, slice(a, b)), _sliced(o4, slice(a, b)), gens(40)[a:b], *args[:3],
            tg4[a:b])[0]
        worst_d = max(worst_d, worst(_sliced(split, slice(a, b)), alone))
    print(f"[10d] make_batched_window of 4 slots from a carried state, {n_win} steps, over the "
          f"(2, 1) data mesh: each slice's chunk against its 2 slots alone, "
          f"worst coordinate {worst_d:.2e} (bar 1e-6); worst coordinate " + ", ".join(
              f"{k} {v:.2e}" for k, v in spread.items()) + f"; a step at G = 4 split 2 + 2 "
          f"{ms_d['split']:.2f} ms, unsplit {ms_d['unsplit']:.2f} ms (CUDA events, mean of the "
          f"window)", flush=True)
    check(worst_d <= 1e-6, f"10d split window {worst_d}")
    del p4, o4, win, split, alone, tg4
    torch.cuda.empty_cache()

    # encode_images_batched: the 4 images over the data mesh, and the first
    # slice's 2 images alone (slot i seeds from (seed, i), so the mesh's
    # first slice computes what a batch of those 2 does): the first slice's
    # files must be those of the 2 alone, byte for byte (phase 11c holds a
    # mixed-lambda batch of the 2 against them). A 4-image call without the
    # mesh differs from the mesh's by the batch size's rounding, which a
    # fresh trajectory amplifies; it is not run, to keep the script's time.
    runs = (("mesh", four, data_mesh), ("first 2 alone", four[:2], None))
    batch = {}
    for name, imgs, m in runs:
        paths = [str(work / f"{name.replace(' ', '_')}{k}.cool") for k in range(len(imgs))]
        torch.cuda.synchronize()
        t0 = time.time()
        res = encode_images_batched(imgs, cfgs, preset, paths, seed=0, verbose=False,
                                    rdoq=False, profile="tpu",
                                    monitor=EncoderMonitor(device=dev), device=dev, mesh=m)
        torch.cuda.synchronize()
        batch[name] = {"wall_s": time.time() - t0, "paths": paths,
                       "psnr_db": [r["psnr_db"] for r in res],
                       "n_bytes": [r["n_bytes"] for r in res]}
    for k in range(2):
        check(Path(batch["mesh"]["paths"][k]).read_bytes()
              == Path(batch["first 2 alone"]["paths"][k]).read_bytes(),
              f"10d image {k}: the mesh's file differs from the 2 images' alone")
    wfd.KERNEL.launches = 0
    decoded, d_routes = decode_images(batch["mesh"]["paths"], device=dev, return_routes=True)
    torch.cuda.synchronize()
    d_launches = wfd.KERNEL.launches
    check(all(r["path"] == "device" for r in d_routes), f"10d routes {d_routes}")
    for k, (p, dec, f) in enumerate(zip(batch["mesh"]["psnr_db"], decoded, four)):
        p_d = dist_to_db(float(np.mean(np.square(np.asarray(dec.data, np.float64)
                                                 - np.asarray(f.data, np.float64)))))
        check(abs(p_d - p) < 0.3, f"10d image {k}: decoder {p_d:.3f} vs encoder {p:.3f}")
    for p in batch["mesh"]["paths"]:
        check_file_grids(Path(p), dev)
    print(f"[10d] encode_images_batched of 4 {four[0].img_size[0]}x{four[0].img_size[1]} "
          f"images over the data mesh (2, 1): psnr " + ", ".join(
              f"{x:.3f}" for x in batch["mesh"]["psnr_db"]) + " dB, bytes " + ", ".join(
              str(x) for x in batch["mesh"]["n_bytes"])
          + f", {batch['mesh']['wall_s']:.1f} s; the first 2 alone "
          f"{batch['first 2 alone']['wall_s']:.1f} s, files identical to the mesh's first "
          f"slice; the mesh's files decode in {d_launches} launches, every grid kernel == "
          f"host C++", flush=True)
    check(d_launches > 0, "10d: decode_images launched no wavefront_decode kernel")
    return {"window_worst": worst_d, "window_spread": spread, "window_steps": n_win,
            "step_ms_split": ms_d["split"], "step_ms_whole": ms_d["unsplit"],
            "encodes": {k: {kk: vv for kk, vv in v.items() if kk != "paths"}
                        for k, v in batch.items()},
            "decode_launches": d_launches}


def encode_big(dev, src: Path, wd: Path, mesh=None) -> dict:
    """Phase 10c's encode of `src` into the new workdir `wd`:
    encode_one_frame at hop with main_only_preset (no warm-up, 60 steps),
    `tpu`, no RDOQ, whole or over `mesh`."""
    from coolchic_tpu_torch.train.video import encode_one_frame
    from coolchic_tpu_torch.utils.codingstructure import CodingStructure
    from coolchic_tpu_torch.utils.parsecli import intra_operating_points

    cs = CodingStructure(n_frames=1, intra_pos=[0])
    wd.mkdir()
    return encode_one_frame(cs.get_frame_from_coding_order(0), cs, str(src), str(wd),
                            main_only_preset(), {"residue": intra_operating_points()["hop"]},
                            verbose=False, rdoq=False, profile="tpu", device=dev, mesh=mesh)


def multi_device_phase(dev, frames: list, work: Path) -> dict:
    """Phase 10: multi-device on one card, the mesh (cuda:0, cuda:0).
    (a) one 2048x3072 hop training step split over 2 space shards against
    the whole step; a 4-step window; ms per step, host ms and peak of both;
    (b) make_spatial_synthesis against the whole eval forward; (c)
    encode_one_frame whole and with the 2-shard mesh (60 steps, no warm-up,
    `tpu`, no RDOQ), the sharded file decoded through the kernel; the
    CLI's --spatial_shard refusal and `auto`; (d) make_batched_window and
    encode_images_batched of 4 512x768 frames over a (2, 1) data mesh; (e)
    the two-process run (gloo, both ranks on the card)."""
    import numpy as np
    import torch

    from coolchic_tpu_torch import cc_encode
    from coolchic_tpu_torch.bitstream.decode import decode_video
    from coolchic_tpu_torch.io.framedata import FrameData
    from coolchic_tpu_torch.io.io import save_frame_data_to_file
    from coolchic_tpu_torch.models.coolchic import (
        coolchic_forward,
        ifce_context,
        latent_rate,
        quantize_latents,
    )
    from coolchic_tpu_torch.models.frame import (
        FrameConfig,
        frame_encoder_forward,
        frame_encoder_init,
    )
    from coolchic_tpu_torch.ops import wavefront_decode as wfd
    from coolchic_tpu_torch.parallel.batch import make_mesh, make_spatial_synthesis
    from coolchic_tpu_torch.parallel.dcn import launch_dcn_dryrun
    from coolchic_tpu_torch.parallel.spatial import resolve_spatial_shard
    from coolchic_tpu_torch.train.loss import dist_to_db
    from coolchic_tpu_torch.train.params import tree_flatten_with_path, tree_leaves, tree_map
    from coolchic_tpu_torch.train.train import PhaseFns, TorchNoise, init_opt_state
    from coolchic_tpu_torch.utils.parsecli import (
        coolchic_config_from_args,
        intra_operating_points,
    )

    work.mkdir()
    mesh = make_mesh(devices=[dev, dev], space=2)
    f0 = frames[0]
    big = FrameData(f0.bitdepth, f0.frame_data_type,
                    np.ascontiguousarray(np.tile(np.asarray(f0.data), (1, 1, 4, 4))))
    H, W = big.img_size
    src = work / "big.ppm"
    save_frame_data_to_file(big, str(src))
    cfg = coolchic_config_from_args(intra_operating_points()["hop"], (H, W))
    fcfg = FrameConfig(coolchic_cfg={"residue": cfg})
    params = frame_encoder_init(torch.Generator().manual_seed(10), fcfg)
    rng = np.random.default_rng(10)
    params["residue"]["latents"] = [
        torch.tensor(rng.normal(0, 1.5, tuple(x.shape)).astype(np.float32) / cfg.encoder_gain)
        for x in params["residue"]["latents"]]
    like = tree_map(lambda x: x[None].to(dev), params)
    target = torch.as_tensor(np.asarray(big.data, np.float32), device=dev)
    lmbda = torch.full((1,), 1e-3, device=dev)
    level = torch.full((1,), 0.2, device=dev)
    fns = {name: PhaseFns(fcfg, like, "gaussian", "softround", {"mse": 1.0}, (0.95, 0.95),
                          (0.9, 0.999), 10, mesh=m)
           for name, m in (("whole", None), ("2 shards", mesh))}
    out: dict = {"frame": [H, W], "mesh": [str(d) for d in mesh.devices]}

    # --- (a) one step, a 4-step window, ms per step, peak
    noise = TorchNoise(torch.Generator(device=dev).manual_seed(5))(
        "step", fcfg, 1, "gaussian", level, True)
    leaves = tree_leaves(like)
    step = {}
    for name, f in fns.items():
        with torch.no_grad():
            lo = float(f.loss(leaves, noise, 0.3, target, lmbda).loss[0])
        step[name] = (lo, f.grads(leaves, noise, 0.3, target, lmbda))
    (l_w, g_w), (l_s, g_s) = step["whole"], step["2 shards"]
    worst = max((float((a.double() - b.double()).norm() / b.double().norm()), path)
                for (path, _), a, b in zip(tree_flatten_with_path(like), g_s, g_w)
                if b is not None and float(b.abs().max()) != 0.0)
    del step, g_w, g_s
    print(f"[10a] one {H}x{W} hop step on the mesh ({mesh.devices[0]} x 2) against the whole "
          f"step: loss {l_s:.8f} vs {l_w:.8f}; worst leaf gradient |diff|_2/|whole|_2 "
          f"{worst[0]:.2e} ({worst[1]}), bar {STEP_GRAD_TOL:.0e}", flush=True)
    check(abs(l_s - l_w) <= 1e-5 * abs(l_w), f"10a step loss {l_s} vs {l_w}")
    check(worst[0] <= STEP_GRAD_TOL, f"10a step gradient {worst[1]}: {worst[0]:.2e}")

    def window(f, n, seed=6, timed=False):
        lv = tree_leaves(like)
        st = init_opt_state(lv, f.groups, f.hp_weight, f.hp_latent)
        draw = TorchNoise(torch.Generator(device=dev).manual_seed(seed))
        ev = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        for s in range(n):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            lv, st = f.step(lv, st, draw("step", fcfg, 1, "gaussian", level, True), 0.3,
                            torch.tensor(1e-2, device=dev), target, lmbda,
                            refresh=(s + 1) % f.pf == 0)
            e1.record()
            ev.append((e0, e1))
        torch.cuda.synchronize()
        host = 1e3 * (time.time() - t0) / n
        ms = [a.elapsed_time(b) for a, b in ev]
        return lv, {"step_ms": statistics.median(ms[1:] if timed else ms), "host_ms": host,
                    "peak_bytes": torch.cuda.max_memory_allocated(dev)}

    res4 = {name: window(f, 4)[0] for name, f in fns.items()}
    ev4 = {name: float(fns[name].eval(lv, target, lmbda).loss[0]) for name, lv in res4.items()}
    lat_err = float((res4["2 shards"][0] - res4["whole"][0]).abs().max())
    print(f"[10a] 4-step window: eval loss sharded {ev4['2 shards']:.8f} vs whole "
          f"{ev4['whole']:.8f} (bar 1e-3 relative); latents[0] max |diff| {lat_err:.2e} "
          f"(bar 2e-4)", flush=True)
    check(abs(ev4["2 shards"] - ev4["whole"]) <= 1e-3 * abs(ev4["whole"]), f"10a window {ev4}")
    check(lat_err <= 2e-4, f"10a window latents {lat_err}")
    del res4
    timing = {name: window(f, 21, timed=True)[1] for name, f in fns.items()}
    for name, t in timing.items():
        print(f"[10a] {name}: {t['step_ms']:.2f} ms a step (CUDA events, median of 20), host "
              f"{t['host_ms']:.2f} ms a step, peak {t['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    with torch.no_grad():
        grids = quantize_latents(like["residue"], cfg, noise=None, quantizer_type="hardround",
                                 soft_round_temperature=0.3)
        ifce_ms = cuda_ms(lambda: ifce_context(like["residue"], cfg, grids))
        rate_ms = cuda_ms(lambda: latent_rate(like["residue"], cfg, grids))
    print(f"[10a] forward, whole on the first device: IFCE context {ifce_ms:.2f} ms of the "
          f"rate's {rate_ms:.2f} ms (contexts, IFCE, ARM)", flush=True)
    out["a"] = {"loss": [l_w, l_s], "grad_worst": worst, "window_loss": ev4,
                "window_latent_err": lat_err, "timing": timing, "ifce_ms": ifce_ms,
                "rate_ms": rate_ms}

    # --- (b) the decode-side float path
    with torch.no_grad():
        whole = coolchic_forward(like["residue"], cfg, training=False).raw_out
        split = coolchic_forward(like["residue"], cfg, training=False, mesh=mesh).raw_out
        float_err = float((split - whole).abs().max())
        dec_w = frame_encoder_forward(like, fcfg, training=False).decoded_image
        dec_s = make_spatial_synthesis(fcfg, mesh)(params)
        codes = (dec_s - dec_w).abs() * 255
    code_max, code_share = float(codes.max()), float((codes > 0.5).float().mean())
    del whole, split, dec_w, dec_s, codes
    print(f"[10b] decode-side float path on the mesh against the whole eval forward: max "
          f"|diff| {float_err:.2e} (bar 2e-5); make_spatial_synthesis's 8-bit image: max "
          f"{code_max:.0f} code, {code_share:.2e} of the samples differ", flush=True)
    check(float_err <= 2e-5, f"10b float path {float_err}")
    check(code_max <= 1.0, f"10b decoded image {code_max} codes")
    out["b"] = {"float_err": float_err, "code_max": code_max, "code_share": code_share}
    del like, fns, target, leaves, noise
    torch.cuda.empty_cache()

    # --- (c) the encode, whole and on the 2-shard mesh (each run repeats
    # bit for bit, cuDNN deterministic being the port's default: what
    # differs between the two is the split alone)
    enc = {}
    for name, m in (("whole", None), ("2 shards", mesh)):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        r = encode_big(dev, src, work / ("enc_whole" if m is None else "enc_sharded"), m)
        torch.cuda.synchronize()
        enc[name] = {"psnr_db": r["logs"].psnr_db, "n_bytes": r["n_bytes"],
                     "wall_s": time.time() - t0, "stages_s": r["monitor"].phase_time_sec,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "payload": r["payload"]}
        print(f"[10c] encode_one_frame {name}: {enc[name]['psnr_db']:.3f} dB, "
              f"{enc[name]['n_bytes']} bytes, {enc[name]['wall_s']:.1f} s, peak "
              f"{enc[name]['peak_bytes'] / 2**30:.2f} GiB; stages " + ", ".join(
                  f"{k} {v:.2f}" for k, v in enc[name]["stages_s"].items()), flush=True)
    e_w, e_s = enc["whole"], enc["2 shards"]
    check(abs(e_w["psnr_db"] - e_s["psnr_db"]) < 0.1, f"10c psnr {e_w['psnr_db']} vs "
          f"{e_s['psnr_db']}")
    check(abs(e_w["n_bytes"] - e_s["n_bytes"]) <= 0.05 * e_w["n_bytes"],
          f"10c bytes {e_w['n_bytes']} vs {e_s['n_bytes']}")
    path = work / "sharded.cool"
    path.write_bytes(e_s.pop("payload"))
    (work / "whole.cool").write_bytes(e_w.pop("payload"))   # phase 11d's yardstick
    routes: list = []
    wfd.KERNEL.launches = 0
    t0 = time.time()
    dec = decode_video(str(path), device=dev, routes=routes)["0"]
    torch.cuda.synchronize()
    dec_s_time, dec_launches = time.time() - t0, wfd.KERNEL.launches
    p_dec = dist_to_db(float(np.mean(np.square(np.asarray(dec.data, np.float64)
                                               - np.asarray(big.data, np.float64)))))
    k_levels = check_file_grids(path, dev)
    lv_routes = level_routes(path, dev)
    print(f"[10c] decode_video of the sharded file: {dec_s_time:.2f} s, wavefront_decode "
          f"launches {dec_launches}, routes {[r['path'] for r in routes]}; decoder psnr "
          f"{p_dec:.3f} dB vs encoder {e_s['psnr_db']:.3f}; every grid kernel == host C++ "
          f"(kernel levels {k_levels})", flush=True)
    for r in lv_routes:
        print(f"[10c]   level {r['level']} {r['shape']}: {r['streams']} streams, {r['route']}"
              + (f", {r['kernel_ms']:.3f} ms over {r['wavefronts']} wavefronts (step "
                 f"{r['step']})" if "kernel_ms" in r else "")
              + (f" ({r['why']})" if "why" in r else ""), flush=True)
    check(dec_launches > 0, "10c: decode_video launched no wavefront_decode kernel")
    check(abs(p_dec - e_s["psnr_db"]) < 0.3, f"10c decoder psnr {p_dec} vs {e_s['psnr_db']}")
    cli_argv = ["-i", str(src), "-o", str(work / "cli.cool"), "--workdir",
                str(work / "cli"), "--recipe", "debug", "--no_rdoq", "--device", "cuda"]
    rc_refuse = cc_encode.main([*cli_argv, "--spatial_shard", "2"])
    check(rc_refuse != 0 and not (work / "cli.cool").exists(),
          f"--spatial_shard 2 on {torch.cuda.device_count()} card(s) exited {rc_refuse}")
    auto = resolve_spatial_shard("auto", dev, torch.cuda.device_count(), H * W)
    check(auto == 0, f"--spatial_shard auto on one card resolved to {auto}")
    print(f"[10c] the CLI with --spatial_shard 2 on {torch.cuda.device_count()} card exits "
          f"{rc_refuse} (refused); auto resolves to {auto}", flush=True)
    out["c"] = {"encode": enc, "decoder_psnr": p_dec, "decode_s": dec_s_time,
                "decode_launches": dec_launches, "levels": lv_routes,
                "cli_refusal_rc": rc_refuse, "auto": auto}

    out["d"] = data_mesh_phase(dev, frames[:4], work)

    # --- (e) two processes, both ranks on the card, gloo
    t0 = time.time()
    outs = launch_dcn_dryrun(n_devices=4, num_processes=2, device="cuda", backend="gloo",
                             timeout=300)
    dcn_s = time.time() - t0
    ok = [o.strip().splitlines()[-1] for o in outs]
    print(f"[10e] launch_dcn_dryrun (4 mesh devices, 2 processes, gloo, cuda): {dcn_s:.1f} s; "
          + " | ".join(ok), flush=True)
    out["e"] = {"seconds": dcn_s, "workers": ok}
    return out


def decode_back(tag: str, path: Path, dev, n_frames: int = 1) -> int:
    """The first n_frames (in coding order) of `path` decoded by decode_video
    on the card: its wavefront_decode launches, counted from 0; every grid
    of every cool-chic, device path == host C++."""
    import torch

    from coolchic_tpu_torch.bitstream.decode import decode_video
    from coolchic_tpu_torch.ops import wavefront_decode as wfd

    wfd.KERNEL.launches = 0
    decoded = decode_video(str(path), max_decoding_order=n_frames - 1, device=dev)
    torch.cuda.synchronize()
    launches = wfd.KERNEL.launches
    check(len(decoded) == n_frames, f"{tag}: decoded {sorted(decoded)}")
    check(launches > 0, f"{tag}: decode_video launched no wavefront_decode kernel")
    file_grids_on_host(tag, path, dev)
    return launches


def determinism_cost(dev, images, big, n_steps: int = 6) -> dict:
    """Phase 11f: ms per training step (the debug preset's main phase,
    make_batched_window, CUDA events over a window of n_steps) at n = 1 and
    G = len(images) on `images`, and whole on `big`, with cuDNN
    deterministic (the port's default) and not, in turns (det, free, free,
    det). The two deterministic windows start from one state and must end
    on the same parameters, bit for bit."""
    import numpy as np
    import torch

    from coolchic_tpu_torch.models.frame import FrameConfig
    from coolchic_tpu_torch.parallel.batch import (
        batched_init,
        make_batched_window,
        make_mesh,
        phase_key,
    )
    from coolchic_tpu_torch.train.params import tree_leaves
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, \
        intra_operating_points

    phase = PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1).training_phases[0]
    one = make_mesh(devices=[dev])
    out = {}
    for name, x in ((f"n = 1, {images.shape[-2]}x{images.shape[-1]}", images[:1]),
                    (f"G = {len(images)}, {images.shape[-2]}x{images.shape[-1]}", images),
                    (f"whole {big.shape[-2]}x{big.shape[-1]}", big)):
        G = x.shape[0]
        fcfg = FrameConfig(coolchic_cfg={"residue": coolchic_config_from_args(
            intra_operating_points()["hop"], tuple(x.shape[-2:]))})
        tg = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        params, opt = batched_init(fcfg, phase, G, seed=0, device=dev)
        window = make_batched_window(fcfg, phase_key(phase), n_steps, one)

        def run():
            gens = [torch.Generator(device=dev).manual_seed(40 + i) for i in range(G)]
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            p = window(params, opt, gens, phase.lr, 0.3, 0.25, tg)[0]
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / n_steps, tree_leaves(p)

        run()   # warm-up
        ms = {True: [], False: []}
        ends = []
        try:
            for det in (True, False, False, True):
                torch.backends.cudnn.deterministic = det
                t, leaves = run()
                ms[det].append(t)
                if det:
                    ends.append(leaves)
        finally:
            torch.backends.cudnn.deterministic = True
        rep = max(float((a - b).abs().max()) for a, b in zip(*ends))
        out[name] = {"det_ms": ms[True], "free_ms": ms[False],
                     "ratio": statistics.mean(ms[True]) / statistics.mean(ms[False]),
                     "det_repeat_max_abs": rep}
        print(f"[11f] {name}: ms a step (CUDA events, mean of a {n_steps}-step window) cuDNN "
              f"deterministic {ms[True][0]:.2f} / {ms[True][1]:.2f}, not {ms[False][0]:.2f} / "
              f"{ms[False][1]:.2f}: {out[name]['ratio']:.3f}x; the two deterministic windows "
              f"differ by {rep:.2e}", flush=True)
        check(rep == 0.0, f"11f {name}: two deterministic windows differ by {rep}")
        del params, opt, tg, ends
        torch.cuda.empty_cache()
    return out


def reproducibility_phase(dev, frames: list, p5: Path, p8: Path, p10: Path,
                          work: Path) -> dict:
    """Phase 11: the encoder repeats itself on the card at the port's
    defaults. (a) phase 5's intra CLI run again, (b) phase 8's P2
    again, (c) a mixed-λ and a uniform-λ batch of 2, (d) phase 10c's whole
    2048x3072 encode again: byte-identical files, each decoded back through
    the kernel; (e) every path that trains, at the defaults and under
    torch.use_deterministic_algorithms(True), which must raise nothing and
    end on the same parameters, bit for bit; (f) the cost of deterministic
    cuDNN."""
    import numpy as np
    import torch

    from coolchic_tpu_torch import cc_encode
    from coolchic_tpu_torch.ops import wavefront_decode as wfd
    from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.train.train import EncoderMonitor
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, \
        intra_operating_points

    work.mkdir()
    out: dict = {}

    # (a) the intra CLI again, as phase 5 ran it on its image
    (work / "a").mkdir()
    run = run_cli(dev, "11a", ["-i", str(p5 / "target.ppm"), *INTRA_ARGV], work / "a")
    again, first = (work / "a" / "out.cool").read_bytes(), (p5 / "out.cool").read_bytes()
    print(f"[11a] the intra CLI again on phase 5's image: {len(again)} bytes against phase "
          f"5's {len(first)}, identical {again == first}", flush=True)
    check(again == first, "11a: the intra CLI run again wrote another file than phase 5's")
    out["a"] = {"bytes": len(again), "launches": run["launches"], "psnr_db": run["psnr_db"]}

    # (b) phase 8's P2 again, from I0 as phase 8 left it
    wb = work / "b"
    wb.mkdir()
    clip = next(p8.glob("clip_*.yuv"))
    shutil.copy(next((p8 / "w").glob("0000-decoded_*.yuv")), wb)
    shutil.copy(p8 / "i_only.cool", wb / "out.cool")
    wfd.KERNEL.launches = 0
    rc = cc_encode.main([*video_cli_argv(clip, wb / "out.cool", wb), "--coding_idx", "1"])
    torch.cuda.synchronize()
    b_launches = wfd.KERNEL.launches
    check(rc == 0, f"11b: cc_encode P2 exited {rc}")
    new, old = (wb / "out.cool").read_bytes(), (p8 / "ip_only.cool").read_bytes()
    file_grids_on_host("[11b]", wb / "out.cool", dev)
    print(f"[11b] phase 8's P2 encoded again (RDOQ on): I0 + P2 {len(new)} bytes against phase "
          f"8's {len(old)}, identical {new == old}; its decode-back launched wavefront_decode "
          f"{b_launches} times", flush=True)
    check(new == old, "11b: P2 encoded again differs from phase 8's")
    check(b_launches > 0, "11b: the decode-back launched no wavefront_decode kernel")
    out["b"] = {"bytes": len(new), "launches": b_launches}

    # (c) slot 0 of a mixed-λ batch of 2 against slot 0 of the uniform one,
    # phase 10d's batch of the same 2 frames alone at the preset's λ
    cfgs = {"residue": coolchic_config_from_args(intra_operating_points()["hop"],
                                                 frames[0].img_size)}
    preset = PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1)
    paths = [work / f"c{k}.cool" for k in range(2)]
    t0 = time.time()
    res = encode_images_batched(frames[:2], cfgs, preset, [str(p) for p in paths], seed=0,
                                verbose=False, rdoq=False, profile="tpu", lmbdas=[1e-3, 4e-3],
                                monitor=EncoderMonitor(device=dev), device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    c_launches = [decode_back(f"[11c] slot {k}", p, dev) for k, p in enumerate(paths)]
    mixed, uniform = paths[0].read_bytes(), (p10 / "first_2_alone0.cool").read_bytes()
    print(f"[11c] encode_images_batched of 2 frames at lambda (1e-3, 4e-3): bytes "
          f"{[r['n_bytes'] for r in res]}, {wall:.1f} s; slot 0 {len(mixed)} bytes against "
          f"phase 10d's uniform batch's {len(uniform)}, identical {mixed == uniform}; "
          f"decode-backs {c_launches} launches", flush=True)
    check(mixed == uniform, "11c: slot 0 of the mixed-lambda batch differs from the uniform's")
    out["c"] = {"wall_s": wall, "bytes": [r["n_bytes"] for r in res],
                "psnr_db": [r["psnr_db"] for r in res], "launches": c_launches}

    # (d) phase 10c's whole 2048x3072 encode again
    t0 = time.time()
    r = encode_big(dev, p10 / "big.ppm", work / "d")
    torch.cuda.synchronize()
    (work / "d.cool").write_bytes(r["payload"])
    same_d = r["payload"] == (p10 / "whole.cool").read_bytes()
    d_launches = decode_back("[11d]", work / "d.cool", dev)
    print(f"[11d] phase 10c's whole 2048x3072 encode again: {r['n_bytes']} bytes, "
          f"{r['logs'].psnr_db:.3f} dB, {time.time() - t0:.1f} s, identical to 10c's file "
          f"{same_d}; decode-back {d_launches} launches", flush=True)
    check(same_d, "11d: the whole 2048x3072 encode differs from 10c's")
    out["d"] = {"bytes": r["n_bytes"], "psnr_db": r["logs"].psnr_db, "launches": d_launches}

    # (e) every path that trains: twice at the defaults, once in strict mode
    images = np.concatenate([np.asarray(f.data, np.float32) for f in frames])
    big = np.ascontiguousarray(np.tile(images[:1], (1, 1, 4, 4)))
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())

    def diff(x, y):
        return max(float((a - b).abs().max()) for a, b in zip(x, y))

    out["e"] = {}
    for name, fn in training_paths(dev, images, big).items():
        first = fn()
        torch.use_deterministic_algorithms(True)
        try:
            second = fn()
        except RuntimeError as e:
            fail(f"11e {name} raised under use_deterministic_algorithms(True): {e}")
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        out["e"][name] = {"strict_max_abs": diff(first, second)}
        print(f"[11e] {name}: strict mode (use_deterministic_algorithms(True), "
              f"CUBLAS_WORKSPACE_CONFIG {os.environ.get('CUBLAS_WORKSPACE_CONFIG')}) raised "
              f"nothing; against a run at the defaults {diff(first, second):.2e}", flush=True)
        check(diff(first, second) == 0.0, f"11e {name}: the two runs differ")
        del first, second
    torch.cuda.empty_cache()

    out["f"] = determinism_cost(dev, images, big)
    return out


def main() -> int:
    # phase 11e's strict mode (torch.use_deterministic_algorithms) needs
    # cuBLAS's fixed workspace, set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
        if level == 0:
            # the plain version's time of one level-0 grid for phase 4: it
            # takes tens of seconds (thousands of eager launches) and is no
            # yardstick, so it is not run again there
            plain1_ms = 1e3 * t_p
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
    print(f"[4] level 0 G=1: kernel {kern1_ms:.3f} ms, plain {plain1_ms:.1f} ms (phase 2's "
          f"call, host clock), bound {bound1:.4f} ms ({by1}), host C++ {host_ms:.1f} ms (host "
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
        multi = multi_device_phase(dev, frames, wd / "p10")
        repro = reproducibility_phase(dev, frames, wd / "p5", wd / "p8", wd / "p10", wd / "p11")

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
                             "decode_video I0 P4 B2 B1 B3 (wave)": wave["decode_launches"],
                             "decode_video of the 2-shard 2048x3072 encode (10c)":
                                 multi["c"]["decode_launches"],
                             "decode_images of 4 data-mesh encodes (10d)":
                                 multi["d"]["decode_launches"],
                             "cc_encode decode-back of the intra CLI run again (11a)":
                                 repro["a"]["launches"],
                             "cc_encode decode-back of I0 + P2 encoded again (11b)":
                                 repro["b"]["launches"],
                             "decode_video of the 2 mixed-lambda files of 11c":
                                 sum(repro["c"]["launches"]),
                             "decode_video of the repeated 2048x3072 encode (11d)":
                                 repro["d"]["launches"]},
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
    print(json.dumps({"multi_device": multi, "card": card}), flush=True)
    print(json.dumps({"reproducibility": repro, "card": card}), flush=True)
    tmp.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
