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
  4. timing with CUDA events (warm-up, median of 5): batch decode, kernel
     per level at G = 8, kernel and plain version on one level-0 grid, the
     host C++ decode of that grid as a yardstick, and the kernel's bound;
     level 0 at G = 1, 8 and 32; the ablation line: level 0 at G = 8 for
     the team kernel at T = 4 and 8 and the first design (one thread per
     stream, csrc/wavefront_decode_pr1.cu), each in full (bit-exact against
     the main kernel) and with each part stubbed (-DWFD_ABLATE), in us per
     wavefront; the batch decode split into IFCE + shear, kernels and the
     float tail.

Prints the ablation line, a {"kernels": [...]} line, then the card line, and ends with
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
# H100 SXM peaks (NVIDIA data sheet): HBM
# rate, and the CUDA-core (non-tensor) rate, at which int32 multiply-adds
# issue at most.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# Timing yardsticks of phase 4: (design, team) pairs, and the parts the
# -DWFD_ABLATE bits stub (the first design has no team: 1 thread a stream).
DESIGNS = (("team", 4), ("team", 8), ("first", 1))
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
    plain1_ms = cuda_ms(lambda: wfd.wavefront_decode_plain(*one, **kw), warmup=0)
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
    print(f"[4] level 0 G=1: kernel {kern1_ms:.3f} ms, plain {plain1_ms:.1f} ms, bound "
          f"{bound1:.4f} ms ({by1}), host C++ {host_ms:.1f} ms (host clock; all medians "
          f"of {N_TIMED})", flush=True)

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

    kernels = [{
        "name": "wavefront_decode",
        "route": "cuda",
        "source": "coolchic_tpu_torch/csrc/wavefront_decode.cu",
        "replaces": "coolchic_tpu/ops/pallas_decode.py:437",
        "launches": launches,
        "max_abs_err": max_abs_err,
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
    tmp.cleanup()
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
