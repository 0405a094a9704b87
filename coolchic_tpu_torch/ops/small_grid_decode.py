"""Range decode of the `tpu`-profile grids coded on fewer than 128 streams
(codec.grid_n_streams: 8 streams from 2^10 pixels, else 1): the CUDA
kernel's wrapper, its plain PyTorch version and the host packing.

It replaces no TPU kernel: the JAX package decodes these grids on the
host, with the C++ range decoder (codec.decode_tpu_level_host), and the
port did too. Both compute the same function: the wavefront walk of
docs/tpu_profile.md (pixel (y, x) at wavefront d = x + step * y, the pixels
of a wavefront by ascending y), pixel (y, x) on stream y mod n_streams, the
int32 X.8 ARM and the integer CDF of bitstream/tpu_cdf.py.

The kernel (csrc/small_grid_decode.cu) runs one CTA per (grid, image), the
grids of a launch listed in a job table, with the whole grid in shared
memory. Per wavefront, every pixel's ARM forward runs at once (a team of
TEAM threads a pixel), then one warp a stream decodes its pixels of the
wavefront in coding order. What bounds it is latency: the serial
wavefronts, each one ARM forward and the longest run of one stream's
symbols in it.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.tpu_cdf import PRECISION, SYM_MAX, SYM_MIN
from coolchic_tpu_torch.core.constants import N_POSSIBLE_SCALE
from coolchic_tpu_torch.ops import wavefront_decode as wfd
from coolchic_tpu_torch.utils.build import CudaKernel

# Threads per pixel in the kernel's ARM forward (4 or 8).
TEAM = 8
MAX_THREADS = 1024
# The grid's zero border in shared memory: 4 rows above, 4 columns each side.
PAD = 4
# Fields of a job: h, w, n_streams, image, first stream, out offset, IFCE
# offset (-1: no IFCE inputs), IFCE context width.
JOB_FIELDS = 8
_M32 = 0xFFFFFFFF


def n_slots(h: int, w: int) -> int:
    """Most pixels one wavefront of an [h, w] grid holds."""
    return min(h, -(-w // wfd.tpu_wavefront_step(w)))


def block_threads(h: int, w: int, n_streams: int) -> int:
    """Threads of a CTA that decodes an [h, w] grid on n_streams streams: a
    team per pixel slot and a warp per stream, in whole warps."""
    return -(-max(n_slots(h, w) * TEAM, 32 * n_streams) // 32) * 32


def grid_bytes(h: int, w: int) -> int:
    return (h + PAD) * (w + 2 * PAD)


def smem_bytes(threads: int, grid_b: int, dim: int, n_hidden: int) -> int:
    """Dynamic shared memory of one CTA (must match smem_words in the .cu)."""
    op, rs, as_ = wfd._team_layout(wfd._kernel_dim(dim), TEAM)
    rows = threads // TEAM
    n_int = (2 * rows * as_ + n_hidden * op * rs + 4 * op + n_hidden * op + 4
             + N_POSSIBLE_SCALE + 2 * rows)
    return 4 * n_int + grid_b


def kernel_eligible(h: int, w: int, n_streams: int, dim: int, n_hidden: int) -> bool:
    """Can an [h, w] grid on n_streams streams take the small-grid decode?
    Narrow grids (w <= 9) are coded in raster order, not by wavefront; a
    stream needs a warp of the CTA; the ARM and the grid must fit the CTA's
    shared memory."""
    if not (wfd.MASK < w and 1 <= n_streams < wfd.LANES and 0 < dim <= wfd.MAX_ARM_DIM):
        return False
    threads = block_threads(h, w, n_streams)
    return (threads <= MAX_THREADS and smem_bytes(threads, grid_bytes(h, w), dim, n_hidden)
            <= wfd.SMEM_LIMIT_BYTES)


# ---------------------------------------------------------------------------
# Host packing: one job table, stream table and words buffer for every small
# grid of a batch; launches take contiguous runs of jobs.
# ---------------------------------------------------------------------------
def pack(grids: list[dict]) -> dict:
    """grids: per (grid, image), {"h", "w", "image", "words": u32 arrays
    (one per stream), "ifce_off": offset of the image's context in the
    launch's IFCE buffer or -1, "ifce_w": its width}. Returns numpy int32
    "jobs" [n, JOB_FIELDS], "streams" [m, 2] (first word, words) and
    "words" (u32 bits), and "out_size", the int32 count of every grid."""
    jobs = np.zeros((len(grids), JOB_FIELDS), np.int32)
    streams, chunks = [], []
    n_words = out = 0
    for i, gr in enumerate(grids):
        h, w = gr["h"], gr["w"]
        jobs[i] = (h, w, len(gr["words"]), gr["image"], len(streams), out,
                   gr.get("ifce_off", -1), gr.get("ifce_w", 0))
        for ws in gr["words"]:
            streams.append((n_words, len(ws)))
            chunks.append(np.asarray(ws, np.uint32))
            n_words += len(ws)
        out += h * w
    words = np.concatenate(chunks) if n_words else np.zeros(1, np.uint32)
    return {"jobs": jobs, "streams": np.asarray(streams, np.int32).reshape(-1, 2),
            "words": words.view(np.int32), "out_size": out}


def launch_shape(jobs: np.ndarray) -> tuple[int, int]:
    """(threads, grid bytes) of a launch over the job rows `jobs`."""
    threads = max(block_threads(int(h), int(w), int(ns)) for h, w, ns in jobs[:, :3])
    return threads, max(grid_bytes(int(h), int(w)) for h, w in jobs[:, :2])


_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/small_grid_decode.cu, one library per padded ARM width.
KERNEL = CudaKernel("small_grid_decode", [_p, _i] + [_p] * 9 + [_i] * 8, deps=("tpu_cdf.cuh",),
                    tags={"SGD_DP": "dp", "SGD_TEAM": "t"})


def kernel_defines(dim: int) -> dict[str, int]:
    """The decode path's build of the kernel for an ARM of width `dim`."""
    return {"SGD_DP": wfd._kernel_dim(dim), "SGD_TEAM": TEAM}


def small_grid_decode(jobs: torch.Tensor, streams: torch.Tensor, words: torch.Tensor,
                      wtr: torch.Tensor, btr: torch.Tensor, stw: torch.Tensor,
                      stb: torch.Tensor, ifce: torch.Tensor | None, out: torch.Tensor, *,
                      jobs_np: np.ndarray, taps: tuple, dims: tuple, n_ifce: int) -> None:
    """Decode the grids of the job rows `jobs` ([n, JOB_FIELDS] int32, a
    contiguous run of pack()'s table; jobs_np the same rows on the host)
    into `out` (flat int32, each grid [h, w] at its job's offset). streams,
    words: pack()'s; wtr [G, n_w] / btr [G, n_b] / stw [G, dim*2] / stb
    [G, 2] the images' flat X.8 ARMs (as for wavefront_decode); ifce the
    flat int32 context grids the jobs' IFCE offsets point into ([h_c*w_c,
    n_ifce] each, row-major), or None. Every tensor on one device."""
    dev = words.device
    dim = len(taps) + n_ifce
    n_hidden = len(dims) - 1
    if any(d != (dim, dim) for d in dims[:-1]) or dims[-1] != (dim, 2):
        raise ValueError(f"ARM dims {dims} are not {n_hidden} x ({dim}, {dim}) then ({dim}, 2)")
    for name, t in (("jobs", jobs), ("streams", streams), ("words", words), ("wtr", wtr),
                    ("btr", btr), ("stw", stw), ("stb", stb), ("out", out)) + (
                        (("ifce", ifce),) if ifce is not None else ()):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    for h, w, ns in jobs_np[:, :3].tolist():
        if not kernel_eligible(h, w, ns, dim, n_hidden):
            raise ValueError(f"[{h}, {w}] grid on {ns} streams with ARM width {dim} does "
                             "not fit the small-grid decode")
    if dev.type == "cpu":
        small_grid_decode_plain(streams, words, wtr, btr, stw, stb, ifce, out,
                                jobs_np=jobs_np, taps=taps, dims=dims, n_ifce=n_ifce)
        return
    if dev.type != "cuda":
        raise ValueError(f"small_grid_decode runs on cuda or cpu, not {dev}")
    threads, grid_b = launch_shape(jobs_np)
    defines = kernel_defines(dim)
    KERNEL.launch(defines, jobs, jobs.shape[0], streams, words, wtr, btr, stw, stb,
                  words if ifce is None else ifce, wfd.taps_tensor(taps, dev), out, len(taps),
                  n_ifce, dim, n_hidden, defines["SGD_DP"], defines["SGD_TEAM"], threads,
                  grid_b)


# ---------------------------------------------------------------------------
# The plain PyTorch version: the grids of one shape and stream count at a
# time, one Python iteration per wavefront (the ARM of all its pixels) and
# per round of it (one symbol on each stream). Exact integers in int64, the
# coder state as (hi, lo) 32-bit halves (ops/wavefront_decode.py).
# ---------------------------------------------------------------------------
def small_grid_decode_plain(streams, words, wtr, btr, stw, stb, ifce, out, *,
                            jobs_np: np.ndarray, taps: tuple, dims: tuple,
                            n_ifce: int) -> None:
    """The plain version of the kernel, on small_grid_decode's inputs (but
    the job table, which it reads from jobs_np)."""
    groups: dict[tuple, list[int]] = {}
    for i, (h, w, ns) in enumerate(jobs_np[:, :3].tolist()):
        groups.setdefault((h, w, ns, int(jobs_np[i, 6]) >= 0), []).append(i)
    st = streams.cpu().numpy()
    for (h, w, ns, _), idx in groups.items():
        rows = jobs_np[idx]
        images = torch.as_tensor(rows[:, 3].astype(np.int64), device=words.device)
        arm = wfd._arm_tensors(wtr[images], btr[images], stw[images], stb[images], dims)
        first = [st[j0:j0 + ns] for j0 in rows[:, 4].tolist()]
        grids = _plain_group(words, first, arm, ifce, rows[:, 6].tolist(), rows[:, 7].tolist(),
                             h=h, w=w, ns=ns, taps=taps, n_ifce=n_ifce)
        for g, off in zip(grids, rows[:, 5].tolist()):
            out[off:off + h * w] = g.reshape(-1).to(torch.int32)


def _plain_group(words, first, arm, ifce, ifce_offs, ifce_ws, *, h, w, ns, taps, n_ifce):
    """[n, h, w] int64 grids of n same-shape jobs: first[i] the (first word,
    words) rows of job i's ns streams."""
    dev = words.device
    i64 = torch.int64
    n = len(first)
    step = wfd.tpu_wavefront_step(w)
    ws_ = w + 2 * PAD
    n_spatial = len(taps)

    # each stream's words, zero past its end, and the coder states [n, ns]
    R = max(2, max(int(c) for f in first for _, c in f)) + 1
    buf = torch.zeros((n, ns, R), dtype=i64, device=dev)
    for i, f in enumerate(first):
        for s, (o, c) in enumerate(f.tolist()):
            buf[i, s, :c] = words[o:o + c].to(i64) & _M32
    lo_hi, lo_lo = (torch.zeros((n, ns), dtype=i64, device=dev) for _ in range(2))
    rg_hi, rg_lo = (torch.full((n, ns), _M32, dtype=i64, device=dev) for _ in range(2))
    pt_hi, pt_lo = buf[:, :, 0].clone(), buf[:, :, 1].clone()
    cur = torch.full((n, ns), 2, dtype=i64, device=dev)

    store = torch.zeros((n, (h + PAD) * ws_), dtype=i64, device=dev)
    tap_off = torch.tensor([dy * ws_ + dx for dy, dx in taps], dtype=i64, device=dev)
    syms = torch.arange(SYM_MIN, SYM_MAX + 1, dtype=i64, device=dev)
    with_ifce = n_ifce > 0 and ifce_offs[0] >= 0
    if with_ifce:
        offs = torch.tensor(ifce_offs, dtype=i64, device=dev)[:, None, None]
        wc = torch.tensor(ifce_ws, dtype=i64, device=dev)[:, None, None]
        cols = torch.arange(n_ifce, dtype=i64, device=dev)

    for d in range(wfd.n_wavefronts(h, w)):
        y_lo = max(0, (d - w + step) // step)
        y_hi = min(h - 1, d // step)
        ys = torch.arange(y_lo, y_hi + 1, dtype=i64, device=dev)
        xs = d - step * ys
        pos = (ys + PAD) * ws_ + xs + PAD

        # ---- the ARM of every pixel of the wavefront
        ctx = store[:, pos[:, None] + tap_off] << 8                # [n, p, n_spatial]
        if n_ifce > 0:
            if with_ifce:
                at = offs + ((ys[None, :, None] // 2) * wc + xs[None, :, None] // 2) * n_ifce
                v = ifce[(at + cols).reshape(-1)].to(i64).reshape(n, len(ys), n_ifce)
            else:
                v = torch.zeros((n, len(ys), n_ifce), dtype=i64, device=dev)
            ctx = torch.cat([ctx, v], dim=-1)
        mu_fp, slope = wfd._arm_mu_slope(ctx, arm)

        # ---- rounds: the r-th pixel of each stream in this wavefront
        for r in range(-(-len(ys) // ns)):
            sel = list(range(r * ns, min(len(ys), (r + 1) * ns)))
            s_idx = torch.as_tensor([(y_lo + i) % ns for i in sel], dtype=i64, device=dev)
            scale, quant = wfd._quantile(lo_hi[:, s_idx], lo_lo[:, s_idx], rg_hi[:, s_idx],
                                         rg_lo[:, s_idx], pt_hi[:, s_idx], pt_lo[:, s_idx])
            table = wfd._left_cum(syms, mu_fp[:, sel, None], slope[:, sel, None])
            k = (table <= quant[..., None]).sum(-1) - 1
            left = table.gather(-1, k[..., None])[..., 0]
            nxt = table.gather(-1, (k + 1).clamp(max=SYM_MAX - SYM_MIN)[..., None])[..., 0]
            prob = torch.where(k == SYM_MAX - SYM_MIN, (1 << PRECISION) - left, nxt - left)
            a_hi, a_lo, b_hi, b_lo, ren = wfd._advance(lo_hi[:, s_idx], lo_lo[:, s_idx],
                                                       scale, left, prob)
            c = cur[:, s_idx]
            nw = buf[torch.arange(n, device=dev)[:, None], s_idx, c.clamp(max=R - 1)]
            nw = torch.where(c < R, nw, 0)
            lo_hi[:, s_idx], lo_lo[:, s_idx] = a_hi, a_lo
            rg_hi[:, s_idx], rg_lo[:, s_idx] = b_hi, b_lo
            pt_hi[:, s_idx] = torch.where(ren, pt_lo[:, s_idx], pt_hi[:, s_idx])
            pt_lo[:, s_idx] = torch.where(ren, nw, pt_lo[:, s_idx])
            cur[:, s_idx] = c + ren.to(i64)
            store[:, pos[sel]] = k + SYM_MIN

    return store.reshape(n, h + PAD, ws_)[:, PAD:, PAD:PAD + w]


# ---------------------------------------------------------------------------
# A batch of same-architecture grids from host data (tests, chip_smoke.py).
# ---------------------------------------------------------------------------
def decode_grids(jobs: list[dict], ctx_idx: np.ndarray, n_ifce: int,
                 device: str | torch.device = "cuda", plain: bool = False) -> list[np.ndarray]:
    """Decode small grids from host data: each job {"h", "w", "words": its
    streams' u32 arrays, "arm8": X.8 params, "ifce": [h*w, n_ifce] int or
    None}, any shapes, in one launch. plain runs the plain version on the
    device instead of the kernel. The kernel reads a pixel's IFCE context
    at (y // 2, x // 2) of the coarser grid it comes from, so a context
    must be the nearest x2 upsample that the codec makes (it raises
    otherwise). Returns the int64 grids in job order."""
    from coolchic_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    grids, ctx = [], []
    n_ctx = 0
    for g, j in enumerate(jobs):
        gr = {"h": j["h"], "w": j["w"], "image": g, "words": j["words"]}
        if j.get("ifce") is not None and n_ifce > 0:
            full = np.asarray(j["ifce"], np.int64).reshape(j["h"], j["w"], n_ifce)
            coarse = full[::2, ::2]
            up = np.repeat(np.repeat(coarse, 2, 0), 2, 1)[:j["h"], :j["w"]]
            if not np.array_equal(up, full):
                raise ValueError("the IFCE context is not a nearest x2 upsample")
            gr.update(ifce_off=n_ctx, ifce_w=coarse.shape[1])
            ctx.append(coarse.reshape(-1))
            n_ctx += coarse.size
        grids.append(gr)
    p = pack(grids)
    flat = [wfd.arm8_flat(j["arm8"]) for j in jobs]
    t = {k: torch.as_tensor(p[k], device=dev) for k in ("jobs", "streams", "words")}
    arm = [torch.as_tensor(np.stack([f[k] for f in flat]), device=dev) for k in range(4)]
    ifce = (torch.as_tensor(np.concatenate(ctx).reshape(-1).astype(np.int32), device=dev)
            if ctx else None)
    out = torch.zeros(p["out_size"], dtype=torch.int32, device=dev)
    dims = tuple((int(m.shape[0]), int(m.shape[1])) for m in jobs[0]["arm8"]["trunk_weights"])
    kw = dict(jobs_np=p["jobs"], taps=wfd._tap_list(ctx_idx), dims=dims, n_ifce=n_ifce)
    if plain:
        small_grid_decode_plain(t["streams"], t["words"], *arm, ifce, out, **kw)
    else:
        small_grid_decode(t["jobs"], t["streams"], t["words"], *arm, ifce, out, **kw)
    res, flat_out = [], out.cpu().numpy()
    for row in p["jobs"]:
        h, w, off = int(row[0]), int(row[1]), int(row[5])
        res.append(flat_out[off:off + h * w].reshape(h, w).astype(np.int64))
    return res
