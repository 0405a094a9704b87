"""Decode cells: one closed-loop client calls the program's decode_images
on `batch` distinct files of a frozen `tpu`-profile pool, again as soon as
a call returns, for the window's seconds. Each seed gives the same work:
the calls walk a seeded permutation of the pool, `batch` files at a time,
so every file comes back equally often and only the order changes.

Correct: a sample of the window's calls (reservoir sampling, seeded) is
decoded again by the plain reference (reference/decode.py) after the
window, and each returned 8-bit frame is held to it: the share of samples
that differ and the largest difference in code values.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from portbench import inputs, yardstick
from portbench.reference import decode as ref
from portbench.trace import TracedWindow, span, spans_around, warm_tracer


def call_files(pool: list[str], batch: int, seed: int):
    """The files of call k, k = 0, 1, ...: a seeded permutation of the
    pool, walked `batch` at a time, wrapping."""
    order = np.random.default_rng(seed).permutation(len(pool))
    k = 0
    while True:
        yield [pool[order[(k * batch + j) % len(pool)]] for j in range(batch)]
        k += 1


def compare(frames: list[np.ndarray], refs: list[np.ndarray]) -> dict:
    """Share of 8-bit samples that differ, and the largest code difference."""
    off = n = 0
    worst = 0.0
    for got, want in zip(frames, refs):
        d = np.abs(np.round(np.asarray(got, np.float64) * 255)
                   - np.round(np.asarray(want, np.float64) * 255))
        off += int((d > 0).sum())
        n += d.size
        worst = max(worst, float(d.max()))
    return {"frac_off": off / n, "max_code_off": worst}


def run(run) -> dict:
    from coolchic_tpu_torch.bitstream import decode as dec_mod
    from coolchic_tpu_torch.bitstream import device_decode
    from coolchic_tpu_torch.bitstream.decode import decode_images

    spec, dev = run.spec, run.device
    pool = inputs.pool(spec["pool"])
    inputs.check_manifest(pool)
    paths = [str(inputs.DATA / p) for p in pool]
    cfg = yardstick.coolchic_config(run.config["operating_point"],
                                    tuple(run.config["image_size"]))
    parsed = [ref.parse((inputs.DATA / p).read_bytes()) for p in pool]
    for p, f in zip(pool, parsed):
        if f["cfg"] != cfg:
            raise ValueError(f"portbench/data/{p} is not configuration {run.config['name']}")
    batch = spec["batch"]
    mpix_per_call = batch * cfg.img_size[0] * cfg.img_size[1] / 1e6

    # set-up: every file of the pool once, through the calls the window makes
    # (the first call in a checkout builds the kernel library)
    warm = call_files(paths, batch, run.seed + 1)
    for _ in range(-(-len(paths) // batch)):
        decode_images(next(warm), device=dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    if run.trace:
        warm_tracer(dev, lambda: decode_images(next(warm), device=dev))
    calls = call_files(paths, batch, run.seed)
    rng = np.random.default_rng(run.seed)
    keep, kept = spec["check_calls"], []          # reservoir of (files, frames)
    lat: list[float] = []
    trace_ctx = None

    def timed_calls(n: int, into: list) -> None:
        for _ in range(n):
            files = next(calls)
            t0 = time.perf_counter()
            kept.append((files, decode_images(files, device=dev)))
            into.append(time.perf_counter() - t0)

    run.window_starts()
    if run.trace:
        # trace_calls calls by the host clock alone, then as many with the
        # card's activity traced (busy, kernels), then the host's spans over
        # a few more, for the breakdown of the idle gaps: the profiler slows
        # this host-bound call, so the wall time per call is the first pass's
        traced = []
        timed_calls(spec["trace_calls"], lat)
        with TracedWindow(dev, host_ops=False) as tw:
            timed_calls(spec["trace_calls"], traced)
        trace_ctx = dict(tw.ctx, clock_s=sum(lat))
        for label, v in (("untraced", lat), ("traced", traced)):
            print(f"portbench: {label} calls {' '.join(f'{1e3 * x:.1f}' for x in v)} ms",
                  file=sys.stderr)
        targets = [(device_decode, "prepare_batch", "decode.prepare_batch"),
                   (device_decode.DeviceBatch, "decode", "decode.device_run"),
                   (dec_mod, "_finish_frame", "decode.finish_frame")]
        with spans_around(targets), TracedWindow(dev) as tw_spans:
            for _ in range(spec["span_calls"]):
                files = next(calls)
                with span("decode.call"):
                    kept.append((files, decode_images(files, device=dev)))
        trace_ctx["breakdown"]["idle_gaps"] = tw_spans.ctx["breakdown"]["idle_gaps"]
        n_calls, n_attempted = spec["trace_calls"], len(kept)
        kept = [kept[i] for i in rng.choice(len(kept), size=min(keep, len(kept)),
                                            replace=False)]
    else:
        t_start = time.perf_counter()
        t_end = t_start + run.seconds
        while True:
            files = next(calls)
            t0 = time.perf_counter()
            frames = decode_images(files, device=dev)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            i = len(lat) - 1
            if i < keep:
                kept.append((files, frames))
            else:
                j = int(rng.integers(0, i + 1))
                if j < keep:
                    kept[j] = (files, frames)
            if t1 >= t_end:
                break
        elapsed = t1 - t_start
        n_calls = n_attempted = len(lat)
        q = statistics.quantiles(lat, n=4) if n_calls >= 2 else [lat[0]] * 3
        print(f"portbench: {n_calls} calls, latency min {1e3 * min(lat):.1f} / quartiles "
              f"{' / '.join(f'{1e3 * v:.1f}' for v in q)} / max {1e3 * max(lat):.1f} ms",
              file=sys.stderr)

    device = {"platform": "gpu" if torch.device(dev).type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if torch.device(dev).type == "cuda"
              else "cpu", "count": 1,
              "memory_peak_bytes": torch.cuda.max_memory_allocated()
              if torch.device(dev).type == "cuda" else 0}

    # the check: the sampled calls decoded again by the plain reference
    # (one batched reference decode of every sampled file)
    files = [f for fs, _ in kept for f in fs]
    want = ref.decode_files([open(f, "rb").read() for f in files], device=dev)
    got = compare([fr.data for _, frames in kept for fr in frames], want)
    checks = {k: {"value": got[k], "limit": spec["limits"][k]} for k in got}

    out = {"attempted": n_attempted, "failed": 0, "device": device, "checks": checks}
    if run.trace:
        levels = yardstick.kernel_levels(cfg)
        n_dim = cfg.spatial_context_arm + (cfg.output_feature_ifce if cfg.flag_ifce else 0)
        bound_s, bound_by = 0.0, set()
        for lv in levels:
            h, w = cfg.size_per_latent[lv]
            # the stream words of `batch` files of the pool's mean size
            words = sum(len(ws) for f in parsed for ws in f["blocks"][lv]) * batch // len(parsed)
            s, by, _ = yardstick.kernel_bound(h, w, batch, words, n_dim - cfg.spatial_context_arm,
                                              n_dim, cfg.n_hidden_layers_arm)
            bound_s += s
            bound_by.add(by)
        print(f"portbench: wavefront kernel bound {bound_s * 1e3:.4f} ms per call, by "
              f"{'/'.join(sorted(bound_by))} (H100 SXM peaks: {yardstick.HBM_BYTES_PER_S:.3g} "
              f"B/s, integer ops at the FP32 rate {yardstick.CORE_OPS_PER_S:.3g}/s)",
              file=sys.stderr)
        out["trace"] = {**trace_ctx, "kind": "decode", "calls": n_calls,
                        "wavefronts_per_call": sum(
                            yardstick.n_wavefronts(*cfg.size_per_latent[lv]) for lv in levels),
                        "bound_s_per_call": bound_s, "pixels": n_calls * mpix_per_call * 1e6,
                        "mac_per_px": yardstick.mac_per_pixel(cfg)}
    else:
        out["e2e"] = {"decode_mpix_per_s": n_calls * mpix_per_call / elapsed,
                      "decode_p95_ms": 1e3 * statistics.quantiles(lat, n=100)[94]
                      if len(lat) >= 2 else 1e3 * lat[0]}
    return out
