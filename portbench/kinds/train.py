"""Encode cells: the main training phase of the production intra preset
over G images in one batch, driven as parallel/encode_batch.py:_batched_phase
drives it: the SOAP seeding gradient, then windows of freq_valid steps,
each one call of the program's parallel/batch.py:window_chunks (the
eigenbasis refresh on every precondition_frequency-th step of a window),
each followed by the validation and the best-slot bookkeeping, with the
program's cosine_lr and linear_schedule. _batched_phase itself runs a
whole phase and cannot end on a clock, so the harness makes the same calls
in the same order, and the measured window ends at the first window
boundary after the clock.

Set-up makes everything from the seed on the card: the slots' (image, λ)
pairs (distinct), the initial parameters (one normal draw, scaled per
leaf) and the quantizer's noise (a generator of the benchmark's, handed
to the program as its noise_source). It then runs the seeding gradient,
the first validation and the phase's first steps (`check_steps`, rounded
up to whole refresh periods) through the window's own call: the warm-up,
and what the reference follows. The window goes on from there.

Correct: after the window, the plain reference (reference/train.py)
trains each slot alone from the same parameters, targets, λ and noise
for `check_steps` steps, and the program is held to it, worst slot first:
the first step's loss; each leaf's first clipped gradient norm (read from
the program's SOAP state after one step), the worst leaf; each leaf's
change after step `check_steps`, the median leaf. (Later losses and the
worst leaf's change follow rounding: SOAP seeds its eigenbases from one
gradient whose covariances are rank-deficient, and Adam's first steps move
every coordinate by about lr whatever its size, so a rounding of a
near-zero gradient coordinate changes the trajectory.)
"""

from __future__ import annotations

import itertools
import math
import sys
import time

import numpy as np
import torch

from portbench import inputs, yardstick
from portbench.reference import train as ref
from portbench.trace import TracedWindow, span, spans_around, warm_tracer


class SeedNoise:
    """The benchmark's noise_source: one standard normal draw per latent
    grid per call, scaled by the slot's noise level, from a generator
    seeded by the run's seed; the first `keep` draws are kept."""

    def __init__(self, seed: int, device: str, keep: int):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.keep, self.kept = keep, []

    def __call__(self, kind, fcfg, G, noise_type, level, need):
        if not need:
            return None
        if noise_type != "gaussian":
            raise ValueError("the encode cells draw gaussian noise")
        out = {name: [torch.randn((G, *s), generator=self.gen, device=level.device)
                      * level.reshape(G, 1, 1) for s in cfg.size_per_latent]
               for name, cfg in fcfg.cc_cfgs.items()}
        if len(self.kept) < self.keep:
            self.kept.append({k: [x.clone() for x in v] for k, v in out.items()})
        return out


def init_leaves(paths_shapes: list[tuple[str, tuple]], G: int, seed: int, device: str) -> dict:
    """Each slot's initial parameters, [G, *shape] per leaf, from one normal
    draw on the device: latents at 0.1 (1.6 after the encoder gain), ARM and
    IFCE weights at 1 / fan-in, synthesis weights at 0.5 / sqrt(fan-in),
    biases at 0.01, upsampling kernels a bilinear / Dirac core at 0.02;
    the output transform the identity, unused biases and flows zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [G * math.prod(s) for _, s in paths_shapes]
    draw = torch.randn(sum(sizes), generator=gen, device=device).split(sizes)
    out = {}
    for (path, shape), n in zip(paths_shapes, draw):
        n = n.reshape(G, *shape)
        last = path.rsplit("/", 1)[-1]
        if "global_flow" in path or "_bias/" in path:
            v = torch.zeros_like(n)
        elif "output_transform" in path:
            v = (torch.eye(shape[0], device=device).reshape(1, *shape).expand(G, *shape)
                 if last == "weight" else torch.zeros_like(n))
        elif "latents" in path:
            v = 0.1 * n
        elif "tconv_half" in path or "conv_half" in path:
            core = torch.zeros(shape, device=device)
            if "tconv_half" in path:
                core[-2:] = torch.tensor([0.25, 0.75], device=device)
            else:
                core[-1] = 1.0
            v = core + 0.02 * n
        elif last == "bias":
            v = 0.01 * n
        elif "synthesis" in path:
            v = n * (0.5 / math.sqrt(math.prod(shape[1:])))
        else:                                   # ARM and IFCE weights [out, in]
            v = n / shape[-1]
        out[path] = v.contiguous()
    return out


def _gaps(prog: dict, want: dict, keys) -> np.ndarray:
    """Each leaf's |program's norm - reference's norm| over the larger of
    the reference's norm and the median leaf's."""
    keys = list(keys)
    med = float(np.median([want[k] for k in keys]))
    return np.array([abs(prog[k] - want[k]) / max(want[k], med) for k in keys])


def make_inputs(run) -> dict:
    """Everything the seed makes for both sides: the slots' (image, λ)
    pairs (distinct) and targets, the program's frame config with the
    leaves' paths and shapes, the initial parameters, the first window's
    hyperparameters, and the reference's config and hyperparameters."""
    from coolchic_tpu_torch.models.frame import FrameConfig, frame_encoder_init
    from coolchic_tpu_torch.train.params import tree_leaves
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args

    spec, dev, G = run.spec, run.device, run.spec["batch"]
    phase = spec["phase"]
    op, img_size = run.config["operating_point"], tuple(run.config["image_size"])
    inputs.check_manifest([spec["image"]])
    rgb = inputs.read_ppm(inputs.DATA / spec["image"])
    if spec.get("crop"):                      # the CPU tests' small size
        img_size = tuple(spec["crop"])
        rgb = rgb[:, :img_size[0], :img_size[1]]
    perms = list(itertools.permutations(range(3)))
    lambdas = run.config["lambdas"]
    rng = np.random.default_rng(run.seed)
    pairs = [divmod(int(k), len(lambdas))
             for k in rng.choice(len(perms) * len(lambdas), size=G, replace=False)]
    lam = [lambdas[j] for _, j in pairs]

    cfg = coolchic_config_from_args(op, img_size)
    fcfg = FrameConfig(coolchic_cfg={"residue": cfg}, frame_type="I", frame_data_type="rgb",
                       bitdepth=8)
    shapes_tree = frame_encoder_init(torch.Generator(), fcfg, device="cpu")
    flat = ref.flatten(shapes_tree)
    prog_leaves = tree_leaves(shapes_tree)
    if len(prog_leaves) != len(flat) or not all(a is b for (_, a), b in zip(flat, prog_leaves)):
        raise RuntimeError("the program's leaf order is not the reference's")
    paths_shapes = [(p, tuple(x.shape)) for p, x in flat]
    return {
        "G": G, "phase": phase, "img_size": img_size, "lam": lam, "fcfg": fcfg,
        "target": torch.as_tensor(np.stack([rgb[list(perms[i])] for i, _ in pairs]), device=dev),
        "lmbda": torch.tensor(lam, dtype=torch.float32, device=dev),
        "shapes_tree": shapes_tree, "paths": [p for p, _ in paths_shapes],
        "init": init_leaves(paths_shapes, G, run.seed, dev),
        # the phase's first window as its configuration states it, for the
        # reference (the program's window takes its schedules' values)
        "lr0": phase["lr"], "temp0": phase["softround_temperature"][0],
        "noise0": phase["noise_parameter"][0],
        "rcfg": yardstick.coolchic_config(op, img_size),
        "hp": {"weight": (phase["betas_model"][0], phase["betas_model"][1], 0.01, 256),
               "latent": (phase["betas_latent"][0], phase["betas_latent"][1], 0.0, 0)}}


def reference_runs(x: dict, draws: list[dict], n_check: int, pf: int) -> list[dict]:
    """The plain reference's training of each slot alone, from the inputs
    and the kept noise draws (the seeding draw, then one per step)."""
    out = []
    for g in range(x["G"]):
        params = {p: x["init"][p][g].clone() for p in x["paths"]}
        out.append(ref.train_steps(
            params, x["rcfg"], x["target"][g], x["lam"][g],
            [n[g] for n in draws[0]["residue"]],
            [[n[g] for n in d["residue"]] for d in draws[1:1 + n_check]],
            x["temp0"], x["lr0"], pf, x["hp"]))
    return out


def readings(prog: dict, refs: list[dict]) -> dict:
    """The compared numbers, worst slot: the first step's loss (relative);
    the first clipped gradient's norm, worst leaf; the change's norm after
    the last step, median leaf. prog: {"losses": [N, G], "first": {path:
    [G]}, "change": {path: [G]}}."""
    worst = {"loss_first_rel": 0.0, "grad_norm_gap": 0.0, "change_gap_median": 0.0}
    for g, r in enumerate(refs):
        worst["loss_first_rel"] = max(worst["loss_first_rel"], abs(
            float(prog["losses"][0][g]) - r["losses"][0]) / abs(r["losses"][0]))
        fp = {p: float(v[g]) for p, v in prog["first"].items()}
        worst["grad_norm_gap"] = max(worst["grad_norm_gap"],
                                     float(_gaps(fp, r["first_grad"], fp).max()))
        # leaves the reference's first gradient leaves still (under a
        # thousandth of the median leaf's) move by weight decay and
        # round-off alone: they are left out of the change
        med = float(np.median(list(r["first_grad"].values())))
        moved = [p for p in r["change"] if r["first_grad"][p] >= 1e-3 * med]
        cp = {p: float(prog["change"][p][g]) for p in moved}
        worst["change_gap_median"] = max(worst["change_gap_median"],
                                         float(np.median(_gaps(cp, r["change"], moved))))
    return worst


def run(run) -> dict:
    from coolchic_tpu_torch.parallel.batch import window_chunks
    from coolchic_tpu_torch.parallel.encode_batch import _select
    from coolchic_tpu_torch.train import train as train_mod
    from coolchic_tpu_torch.train.params import tree_unflatten
    from coolchic_tpu_torch.train.train import (PhaseFns, cosine_lr, init_opt_state,
                                                linear_schedule, seed_opt_state)

    spec, dev, G = run.spec, run.device, run.spec["batch"]
    cuda = torch.device(dev).type == "cuda"
    x = make_inputs(run)
    phase, fcfg, target, lmbda = x["phase"], x["fcfg"], x["target"], x["lmbda"]
    paths, init = x["paths"], x["init"]
    like = tree_unflatten(x["shapes_tree"], [init[p] for p in paths])
    leaves0 = [init[p] for p in paths]
    fns = PhaseFns(fcfg, like, phase["quantizer_noise_type"], phase["quantizer_type"],
                   {"mse": 1.0}, tuple(phase["betas_model"]), tuple(phase["betas_latent"]),
                   phase["precondition_frequency"])
    pf = fns.pf
    n_check = spec["check_steps"]
    noise_src = SeedNoise(run.seed + 1, dev, keep=1 + n_check)
    max_itr, freq_valid = phase["max_itr"], phase["freq_valid"]
    t_max = max_itr / freq_valid

    def draw(level):
        lv = torch.full((G,), level, dtype=torch.float32, device=dev)
        return lambda: noise_src("step", fcfg, G, phase["quantizer_noise_type"], lv,
                                 fns.need_noise)

    # ---- set-up: seeding gradient, first validation, the first steps
    leaves = [t.clone() for t in leaves0]
    opt = init_opt_state(leaves, fns.groups, fns.hp_weight, fns.hp_latent)
    temp0 = linear_schedule(phase["softround_temperature"], 0, max_itr)
    noise0 = linear_schedule(phase["noise_parameter"], 0, max_itr)
    grads = fns.grads(leaves, draw(noise0)(), temp0, target, lmbda)
    opt = seed_opt_state(opt, grads, fns.groups, fns.hp_weight)
    del grads
    best_loss = fns.eval(leaves, target, lmbda).loss
    best = [t.clone() for t in leaves]
    patience_windows = max(phase["patience"] // freq_valid, 1)
    since_record = np.zeros(G, dtype=np.int64)
    state = {"cnt": 0, "w_idx": 0, "s": 0, "steps": 0, "windows": 0}
    win = {}

    def window_start():
        """The schedules of the window that starts at step cnt (a phase
        that ends starts over on the same state, as a next phase would)."""
        if state["cnt"] >= max_itr:
            state["cnt"] = state["w_idx"] = 0
        cnt = state["cnt"]
        win.update(lr=torch.tensor(cosine_lr(phase["lr"], state["w_idx"], t_max),
                                   dtype=torch.float32, device=dev),
                   temp=linear_schedule(phase["softround_temperature"], cnt, max_itr),
                   draw=draw(linear_schedule(phase["noise_parameter"], cnt, max_itr)),
                   n=min(freq_valid, max_itr - cnt))

    def validation():
        """After each window, as _batched_phase: the eval, the best slots,
        the host sync, and the patience's reload of the best slots."""
        nonlocal leaves, best, best_loss, since_record
        with span("train.validation"):
            loss = fns.eval(leaves, target, lmbda).loss
            improved = loss < best_loss
            best = _select(improved, leaves, best)
            best_loss = torch.where(improved, loss, best_loss)
            since_record = np.where(improved.cpu().numpy(), 0, since_record + 1)
            if (since_record > patience_windows).any():
                reload = since_record > patience_windows
                leaves = _select(torch.as_tensor(reload, device=dev), best, leaves)
                since_record[reload] = 0

    def advance(n: int) -> None:
        """n steps of the phase from where it stands: the program's window
        call on the rest of each window (its refresh counts from the call's
        start, so a call starts a whole number of refresh periods into its
        window), the validation at each window's end."""
        nonlocal leaves, opt
        while n > 0:
            k = min(n, win["n"] - state["s"])
            (leaves, opt), = window_chunks([fns], [(leaves, opt)], [win["draw"]], k, win["temp"],
                                           [win["lr"]], [target], [lmbda], [None])
            state["s"] += k
            state["steps"] += k
            n -= k
            if state["s"] == win["n"]:
                validation()
                state["cnt"] += win["n"]
                state["w_idx"] += 1
                state["s"] = 0
                state["windows"] += 1
                window_start()

    # the first steps, through the window's own call: the program's loss and
    # SOAP state are read on the way for the check
    losses_prog, first_norm, change_prog = [], [], []
    loss_prog, step_prog = fns.loss, fns.step
    n_done = itertools.count(1)

    def loss_hook(*a, **k):
        lo = loss_prog(*a, **k)
        losses_prog.append(lo.loss.detach().clone())
        return lo

    def step_hook(*a, **k):
        new_leaves, new_opt = step_prog(*a, **k)
        i = next(n_done)
        if i == 1:
            first_norm.extend(
                None if st is None else
                torch.linalg.vector_norm(st["exp_avg"].flatten(1), dim=1)
                / (1.0 - (phase["betas_latent"][0] if grp == "latent"
                          else phase["betas_model"][0]))
                for st, grp in zip(new_opt, fns.groups))
        if i == n_check:
            change_prog.extend(torch.linalg.vector_norm((a - b).flatten(1), dim=1)
                               for a, b in zip(new_leaves, leaves0))
        return new_leaves, new_opt

    window_start()
    fns.loss, fns.step = loss_hook, step_hook
    advance(-(-n_check // pf) * pf)
    del fns.loss, fns.step
    # a step that computes no loss leaves the first step's loss unread
    prog = {"losses": torch.stack(losses_prog).cpu().numpy() if losses_prog
            else np.full((1, G), np.inf),
            "first": {p: v.cpu().numpy() for p, v in zip(paths, first_norm) if v is not None},
            "change": {p: v.cpu().numpy() for p, v in zip(paths, change_prog)}}
    if run.trace:
        warm_tracer(dev, lambda: advance(pf))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # ---- the window
    trace_ctx = None
    steps0 = state["steps"]
    run.window_starts()
    if run.trace:
        targets = [(fns, "grads", "train.grads"),
                   (train_mod, "soap_step_leaf", "train.soap_leaf")]
        # trace_steps steps by the host clock alone, then as many with the
        # card's activity traced (busy, kernels, launches), then the host's
        # spans over a few more, for the breakdown of the idle gaps: the
        # profiler slows a dispatch-bound step, so the wall time per step is
        # the first pass's
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        advance(spec["trace_steps"])
        if cuda:
            torch.cuda.synchronize()
        clock_s = time.perf_counter() - t0
        with TracedWindow(dev, host_ops=False) as tw:
            advance(spec["trace_steps"])
        trace_ctx = dict(tw.ctx, clock_s=clock_s)
        print(f"portbench: {spec['trace_steps']} steps {clock_s:.4f} s untraced, "
              f"{tw.ctx['wall_s']:.4f} s traced", file=sys.stderr)
        with spans_around(targets), TracedWindow(dev) as tw_spans:
            with span("train.steps"):
                advance(spec["span_steps"])
        trace_ctx["breakdown"]["idle_gaps"] = tw_spans.ctx["breakdown"]["idle_gaps"]
        n_steps = state["steps"] - steps0
    else:
        # whole windows until the clock has run out: the rest of the window
        # that set-up began, then window after window
        t_start = time.perf_counter()
        t_end = t_start + run.seconds
        advance(win["n"] - state["s"])
        while time.perf_counter() < t_end:
            advance(win["n"])
        if cuda:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t_start
        n_steps = state["steps"] - steps0
        print(f"portbench: {n_steps} steps, {state['windows']} windows validated in all, "
              f"{elapsed:.3f} s", file=sys.stderr)

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1,
              "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}

    # ---- the check: each slot trained alone by the plain reference
    del leaves, opt, best, fns, like
    if cuda:
        torch.cuda.empty_cache()
    checks = {k: {"value": v, "limit": spec["limits"][k]}
              for k, v in readings(prog, reference_runs(x, noise_src.kept, n_check, pf)).items()}

    out = {"attempted": G * n_steps, "failed": 0, "device": device, "checks": checks}
    if run.trace:
        out["trace"] = {**trace_ctx, "kind": "train", "steps": spec["trace_steps"],
                        "img_steps": G * spec["trace_steps"], "pixels": x["img_size"][0] * x["img_size"][1],
                        "mac_per_px": yardstick.mac_per_pixel(x["rcfg"])}
    else:
        out["e2e"] = {"train_img_steps_per_s": G * n_steps / elapsed}
    return out
