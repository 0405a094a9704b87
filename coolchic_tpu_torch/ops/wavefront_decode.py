"""Wavefront range decode of `tpu`-profile latent grids (docs/tpu_profile.md):
the CUDA kernel's wrapper, its plain PyTorch version, numpy models of the
kernel's arithmetic shortcuts, and the host packing.

Replaces coolchic_tpu/ops/pallas_decode.py: the Pallas kernel `_make_kernel`
(built and launched by `_build`, `pl.pallas_call`). Both compute the same
function: G same-shape grids, each coded on 128 row-keyed range-coder
streams, are decoded over D = (w-1) + (h-1)*step + 1 serial wavefronts; at
each wavefront every stream decodes at most one pixel (y, x) with
x + step*y = d, from its 9x9 causal context taps, the IFCE context, the
int32 X.8 ARM and the integer Laplace CDF of bitstream/tpu_cdf.py.

The kernel (csrc/wavefront_decode.cu) runs one CTA per grid and a team of
TEAM threads per stream, with the coder state in native u64 registers, the
last OFFMAX+1 wavefronts in a shared-memory ring and one barrier per
wavefront. What bounds it on an H100 is the serial chain of D dependent
wavefronts (3834 at 512x768); the team splits each stream's ARM and symbol
search, so that a wavefront costs the instructions the SM issues and the
lockstep of the barrier rather than one thread's latency.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from coolchic_tpu_torch.bitstream.tpu_cdf import (
    CSL,
    EXP2_POLY,
    FREE_WEIGHT,
    LEAK_STEP,
    PRECISION,
    SL0,
    SYM_MAX,
    SYM_MIN,
)
from coolchic_tpu_torch.core.constants import (
    LOG_SCALE_MIN_FIXED_POINT,
    MU_MIN_FIXED_POINT,
    N_POSSIBLE_MU,
    N_POSSIBLE_SCALE,
)
from coolchic_tpu_torch.utils.build import CudaKernel

MASK = 9
LANES = 128
_M32 = 0xFFFFFFFF
_QMAX = (1 << PRECISION) - 1

# Widest ARM the kernel takes (the host C++ codec's limit too).
MAX_ARM_DIM = 64
# Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232448
# Threads per stream in the kernel (4 or 8; chip_smoke.py times both, and 4
# is the faster at hop's ARM width on an H100: PERF.md).
TEAM = 4


def tpu_wavefront_step(w: int) -> int:
    """Normative wavefront step of the `tpu` profile (must match the C++
    tpu_wavefront_step, csrc/rangecoder.cpp): pixel (y, x) belongs to
    wavefront d = x + step * y. Causality of the 9x9 mask needs step >= 5
    (a dy = -1 tap reaches dx = +4); the 128-stream decode needs the row
    span ceil(w / step) <= 128."""
    return max(5, -(-w // 128))


def _off_max(step: int) -> int:
    """Max |row offset| of a causal tap: |dx + step*dy| <= 4 + 4*step."""
    return 4 + 4 * step


def n_wavefronts(h: int, w: int) -> int:
    return (w - 1) + (h - 1) * tpu_wavefront_step(w) + 1


def words_bucket(max_words: int) -> int:
    """Power-of-two row count of the words buffer for the longest stream in
    a batch."""
    R = 64
    while R < max_words:
        R *= 2
    return R


def _tap_list(ctx_idx: np.ndarray) -> tuple:
    """9x9 flat indices -> ((dy, dx), ...) with dy in [-4, 0]."""
    taps = []
    for idx in np.asarray(ctx_idx).tolist():
        dy = idx // MASK - (MASK - 1) // 2
        dx = idx % MASK - (MASK - 1) // 2
        taps.append((int(dy), int(dx)))
    return tuple(taps)


def _kernel_dim(dim: int) -> int:
    """The kernel's padded ARM width DP (zero weights pad it, exactly): the
    next multiple of 4, fixed per build."""
    if not 0 < dim <= MAX_ARM_DIM:
        raise ValueError(f"ARM width {dim} outside the kernel's 1..{MAX_ARM_DIM}")
    return -(-dim // 4) * 4


def _ring_rows(w: int) -> int:
    """Power-of-two rows of the kernel's shared-memory symbol ring (holds
    the last OFFMAX + 1 wavefronts)."""
    need = _off_max(tpu_wavefront_step(w)) + 1
    r = 1
    while r < need:
        r *= 2
    return r


def _team_layout(dp: int, team: int) -> tuple[int, int, int]:
    """(OP, RS, AS) of the .cu: hidden outputs padded to a multiple of the
    team, and the weight and activation row strides in words (a multiple of
    4 whose quarter is odd, so a quarter-warp's rows fall in distinct
    banks)."""
    def odd4(n: int) -> int:
        return n if (n // 4) % 2 else n + 4

    op = -(-dp // team) * team
    return op, odd4(dp), odd4(-(-op // 4) * 4)


def kernel_smem_bytes(w: int, dim: int, n_hidden: int) -> int:
    """Dynamic shared memory of one CTA (must match smem_words in the .cu)."""
    op, rs, as_ = _team_layout(_kernel_dim(dim), TEAM)
    n_int = (2 * LANES * as_                      # activation rows, double buffered
             + n_hidden * op * rs + n_hidden * op  # hidden weights, biases
             + 4 * op + 4                          # stabiliser and last layer
             + N_POSSIBLE_SCALE)                   # slope table
    return 4 * n_int + _ring_rows(w) * LANES


def kernel_eligible(h: int, w: int, dim: int, n_hidden: int) -> bool:
    """Can a 128-stream [h, w] grid take the wavefront decode? Narrow grids
    (w <= 9) are coded in raster order, not by wavefront; the ARM must fit
    a kernel variant and the CTA's shared memory."""
    return (MASK < w and dim <= MAX_ARM_DIM
            and kernel_smem_bytes(w, dim, n_hidden) <= SMEM_LIMIT_BYTES)


def grid_batch_limit(h: int, w: int, ifce_rows: int, R: int, G: int,
                     device: torch.device) -> int:
    """Largest number of grids (<= G) whose words, IFCE context and output
    fit in half of the device's free memory (the CPU has no limit here)."""
    if device.type != "cuda":
        return G
    D = n_wavefronts(h, w)
    per_grid = 4 * LANES * (R + D * ifce_rows) + 4 * h * w
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(G, int(free // 2 // per_grid)))


# ---------------------------------------------------------------------------
# The CUDA kernel: its build, its arguments, the taps on the device.
# ---------------------------------------------------------------------------
_p, _i = ctypes.c_void_p, ctypes.c_int
# csrc/wavefront_decode.cu, one library per (padded ARM width, team size);
# -DWFD_ABLATE builds (timing variants, see the .cu) are tagged _ab<bits>.
KERNEL = CudaKernel("wavefront_decode", [_p] * 8 + [_i] * 12, deps=("tpu_cdf.cuh",),
                    tags={"WFD_DP": "dp", "WFD_TEAM": "t", "WFD_ABLATE": "ab"})
_TAPS: dict[tuple, torch.Tensor] = {}


def kernel_defines(dim: int) -> dict[str, int]:
    """The decode path's build of the kernel for an ARM of width `dim`."""
    return {"WFD_DP": _kernel_dim(dim), "WFD_TEAM": TEAM}


def taps_tensor(taps: tuple, device: torch.device) -> torch.Tensor:
    """The (dy, dx) taps as a flat int32 tensor on `device`, uploaded once
    per (taps, device) so that a launch does no host-to-device copy."""
    key = (taps, device)
    if key not in _TAPS:
        _TAPS[key] = torch.tensor(taps, dtype=torch.int32, device=device).reshape(-1)
    return _TAPS[key]


def launch_args(defines: dict[str, int], words, wtr, btr, stw, stb, ifce, out, *,
                h: int, w: int, taps: tuple, dims: tuple, n_ifce: int,
                ifce_packed: bool) -> tuple:
    """The arguments of KERNEL's build `defines` (but the stream) that decode
    wavefront_decode's inputs into `out` [G, h, w]."""
    R, G, _ = words.shape
    return (words, wtr, btr, stw, stb, ifce, taps_tensor(taps, words.device), out, h, w, G,
            R, len(taps), ifce.shape[1], int(ifce_packed), len(taps) + n_ifce, len(dims) - 1,
            defines["WFD_DP"], defines["WFD_TEAM"], _ring_rows(w))


def _check_inputs(words, wtr, btr, stw, stb, ifce, h, w, taps, dims, n_ifce,
                  ifce_packed):
    dev = words.device
    R, G, lanes = words.shape
    dim = len(taps) + n_ifce
    n_hidden = len(dims) - 1
    if lanes != LANES:
        raise ValueError(f"words must be [R, G, {LANES}], got {tuple(words.shape)}")
    if any(d != (dim, dim) for d in dims[:-1]) or dims[-1] != (dim, 2):
        raise ValueError(f"ARM dims {dims} are not {n_hidden} x ({dim}, {dim}) "
                         f"then ({dim}, 2)")
    rows = max((n_ifce + 1) // 2 if ifce_packed else n_ifce, 1)
    shapes = {"wtr": (wtr, (G, n_hidden * dim * dim + dim * 2)),
              "btr": (btr, (G, n_hidden * dim + 2)),
              "stw": (stw, (G, dim * 2)), "stb": (stb, (G, 2)),
              "ifce": (ifce, (n_wavefronts(h, w), rows, G, LANES))}
    for name, (t, shape) in [("words", (words, (R, G, LANES)))] + list(shapes.items()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, words on {dev}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not MASK < w:
        raise ValueError(f"wavefront decode needs w > {MASK}, got {w}")
    return dim, n_hidden


def wavefront_decode(words: torch.Tensor, wtr: torch.Tensor, btr: torch.Tensor,
                     stw: torch.Tensor, stb: torch.Tensor, ifce: torch.Tensor, *,
                     h: int, w: int, taps: tuple, dims: tuple, n_ifce: int,
                     ifce_packed: bool) -> torch.Tensor:
    """Decode G same-shape grids. All inputs int32 on one device:
    words [R, G, 128] (u32 bit patterns; stream s of grid g, word r at
    [r, g, s], zero-padded), wtr [G, n_w] / btr [G, n_b] (flat X.8 trunk
    weights [in, out] row-major, layer after layer, and biases), stw
    [G, dim*2], stb [G, 2], ifce [D, rows, G, 128] (sheared IFCE context,
    rows = n_ifce, or ceil(n_ifce/2) int16 pairs when ifce_packed).
    Returns the [G, h, w] int32 symbols."""
    dim, n_hidden = _check_inputs(words, wtr, btr, stw, stb, ifce, h, w, taps, dims,
                                  n_ifce, ifce_packed)
    dev = words.device
    if dev.type == "cpu":
        return wavefront_decode_plain(words, wtr, btr, stw, stb, ifce, h=h, w=w,
                                      taps=taps, dims=dims, n_ifce=n_ifce,
                                      ifce_packed=ifce_packed)
    if dev.type != "cuda":
        raise ValueError(f"wavefront_decode runs on cuda or cpu, not {dev}")
    if not kernel_eligible(h, w, dim, n_hidden):
        raise ValueError(f"[{h}, {w}] grid with ARM width {dim} does not fit "
                         "the kernel")
    out = torch.empty((words.shape[1], h, w), dtype=torch.int32, device=dev)
    defines = kernel_defines(dim)
    KERNEL.launch(defines, *launch_args(defines, words, wtr, btr, stw, stb, ifce, out, h=h,
                                        w=w, taps=taps, dims=dims, n_ifce=n_ifce,
                                        ifce_packed=ifce_packed))
    return out


# ---------------------------------------------------------------------------
# The plain PyTorch version. Every value is an exact integer in int64; the
# 64-bit coder state is carried as (hi, lo) 32-bit halves, since products
# and differences of u64 values overflow torch's signed int64.
# ---------------------------------------------------------------------------
def _exp2_neg24(t: torch.Tensor) -> torch.Tensor:
    """exp2(-t/2^24) in X.24 for int64 t in [0, 2^47); returns <= 2^24.
    torch's >> on int64 is arithmetic (floor), as the spec requires."""
    q = torch.clamp(t >> PRECISION, max=40)
    f = t & ((1 << PRECISION) - 1)
    r = torch.full_like(t, EXP2_POLY[6])
    for k in range(5, -1, -1):
        r = EXP2_POLY[k] + ((r * f) >> PRECISION)
    return torch.clamp(r, 0, 1 << PRECISION) >> q


def _slope_of(idx_sc: torch.Tensor) -> torch.Tensor:
    """slope(idx) = max(1, SL0 * exp2i(idx * CSL) >> 24)."""
    e = _exp2_neg24(idx_sc.to(torch.int64) * CSL)
    return torch.clamp((SL0 * e) >> PRECISION, min=1)


def _left_cum(s: torch.Tensor, mu_fp: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """left_cum(s), s in [SYM_MIN, SYM_MAX] (tpu_cdf.left_cum)."""
    m = s * 256 - 128 - mu_fp
    half = _exp2_neg24(m.abs() * slope) >> 1
    cdf = torch.where(m < 0, half, (1 << PRECISION) - half)
    val = ((FREE_WEIGHT * cdf) >> PRECISION) + (s - SYM_MIN) * LEAK_STEP
    return torch.where(s <= SYM_MIN, 0, val)


def _mul_u32x(a: torch.Tensor, a_hi8: torch.Tensor, b: torch.Tensor):
    """(a_hi8 * 2^32 + a) * b for a < 2^32, a_hi8 < 2^8, b < 2^24 (the
    product is < 2^64) -> (hi, lo) 32-bit halves."""
    p = a * b                                   # < 2^56
    return (p >> 32) + a_hi8 * b, p & _M32


def _arm_tensors(wtr, btr, stw, stb, dims: tuple) -> tuple:
    """The flat X.8 ARM parameters of G grids as int64 tensors: ([G, in, out]
    trunk weights, [G, 1, out] biases, [G, dim, 2] stabiliser weights,
    [G, 1, 2] stabiliser biases)."""
    G = wtr.shape[0]
    i64 = torch.int64
    wmats, bvecs = [], []
    w_off = b_off = 0
    for n_in, n_out in dims:
        wmats.append(wtr[:, w_off:w_off + n_in * n_out].to(i64).reshape(G, n_in, n_out))
        bvecs.append(btr[:, b_off:b_off + n_out].to(i64)[:, None, :])
        w_off += n_in * n_out
        b_off += n_out
    return wmats, bvecs, stw.to(i64).reshape(G, dims[0][0], 2), stb.to(i64)[:, None, :]


def _arm_mu_slope(ctx: torch.Tensor, arm: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The X.8 ARM (exact integers; the kernels' int32 is certified) on
    contexts [G, n, dim] -> (mu_fp, slope), each [G, n]."""
    wmats, bvecs, st_w, st_b = arm
    st = (ctx[..., None] * st_w[:, None]).sum(2) + st_b
    act = ctx
    for li, (wm, bv) in enumerate(zip(wmats, bvecs)):
        acc = (act[..., None] * wm[:, None]).sum(2) + bv
        act = (acc + st) >> 8 if li == len(wmats) - 1 else torch.relu(acc) >> 8
    idx_mu = torch.clamp(act[..., 0] - MU_MIN_FIXED_POINT, 0, N_POSSIBLE_MU - 1)
    slope = _slope_of(torch.clamp(act[..., 1] - LOG_SCALE_MIN_FIXED_POINT, 0,
                                  N_POSSIBLE_SCALE - 1))
    return idx_mu + MU_MIN_FIXED_POINT, slope


def _quantile(lo_hi, lo_lo, rg_hi, rg_lo, pt_hi, pt_lo) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale = range >> 24, min((point - lower) // scale, 2^24 - 1)) of
    coder states held as (hi, lo) 32-bit halves."""
    i64 = torch.int64
    scale = (rg_hi << 8) | (rg_lo >> 24)                  # < 2^40
    t_lo = pt_lo - lo_lo
    t_hi = (pt_hi - lo_hi - (t_lo < 0).to(i64)) & _M32
    t_lo = t_lo & _M32
    a = (t_hi << 16) | (t_lo >> 16)                       # t >> 16
    q_a = a // scale
    r_a = a - q_a * scale
    quant = torch.clamp((q_a << 16) + (((r_a << 16) | (t_lo & 0xFFFF)) // scale), max=_QMAX)
    return scale, quant


def _advance(lo_hi, lo_lo, scale, left, prob) -> tuple:
    """The coder's advance by (left, prob) at `scale`: (lower hi, lower lo,
    range hi, range lo, renormalise) after the renormalisation, which
    shifts lower and range by 32 bits where the new range is below 2^32."""
    sc_hi, sc_lo = scale >> 32, scale & _M32
    al_hi, al_lo = _mul_u32x(sc_lo, sc_hi, left)
    nlo_lo = lo_lo + al_lo
    nlo_hi = (lo_hi + al_hi + (nlo_lo >> 32)) & _M32
    nlo_lo = nlo_lo & _M32
    rp_hi, rp_lo = _mul_u32x(sc_lo, sc_hi, prob)
    renorm = rp_hi == 0
    return (torch.where(renorm, nlo_lo, nlo_hi), torch.where(renorm, 0, nlo_lo),
            torch.where(renorm, rp_lo, rp_hi), torch.where(renorm, 0, rp_lo), renorm)


def wavefront_decode_plain(words, wtr, btr, stw, stb, ifce, *, h: int, w: int,
                           taps: tuple, dims: tuple, n_ifce: int,
                           ifce_packed: bool) -> torch.Tensor:
    """The plain version of the kernel: the same [G, 128] wavefronts, one
    Python iteration per wavefront. Symbols live in an unsheared store
    padded by 4 on the top, left and right, so every out-of-grid tap reads
    0 (the kernel masks the same taps)."""
    dev = words.device
    R, G, _ = words.shape
    step = tpu_wavefront_step(w)
    D = n_wavefronts(h, w)
    n_spatial = len(taps)
    i64 = torch.int64

    words64 = words.to(i64) & _M32
    arm = _arm_tensors(wtr, btr, stw, stb, dims)

    wp = w + 8
    n_store = (h + 4) * wp
    store = torch.zeros((G, n_store + 1), dtype=i64, device=dev)  # +1: dummy
    tap_off = torch.tensor([dy * wp + dx for dy, dx in taps], dtype=i64,
                           device=dev)

    lane = torch.arange(LANES, dtype=i64, device=dev).expand(G, LANES)
    zero = torch.zeros((G, LANES), dtype=i64, device=dev)
    lo_hi, lo_lo = zero, zero
    rg_hi, rg_lo = zero + _M32, zero + _M32
    pt_hi, pt_lo = words64[0], words64[1]
    cur = zero + 2
    flat_words = words64.permute(1, 2, 0).reshape(G, LANES, R)

    for d in range(D):
        y_lo = max(0, (d - w + step) // step)
        y_hi = min(h - 1, d // step)
        y = y_lo + (lane - y_lo) % LANES
        active = y <= y_hi
        x = d - step * y
        pos = torch.where(active, (y + 4) * wp + x + 4, n_store)

        # ---- context: spatial taps (X.8) then the IFCE features (raw X.8)
        ctx = torch.gather(store, 1, (pos[..., None] + tap_off).clamp(0, n_store)
                           .reshape(G, -1)).reshape(G, LANES, n_spatial) << 8
        if n_ifce > 0:
            v = ifce[d].to(i64).permute(1, 2, 0)               # [G, 128, rows]
            if ifce_packed:
                lo16 = ((v & 0xFFFF) ^ 0x8000) - 0x8000
                v = torch.stack([lo16, v >> 16], dim=-1).reshape(G, LANES, -1)
            ctx = torch.cat([ctx, v[..., :n_ifce]], dim=-1)
        ctx = torch.where(active[..., None], ctx, 0)
        mu_fp, slope = _arm_mu_slope(ctx, arm)
        scale, quant = _quantile(lo_hi, lo_lo, rg_hi, rg_lo, pt_hi, pt_lo)

        # ---- 7-step binary search: max s with left_cum(s) <= quantile
        s_sym = torch.full_like(quant, SYM_MIN)
        for st_ in (64, 32, 16, 8, 4, 2, 1):
            cand = s_sym + st_
            ok = (cand <= SYM_MAX) & (_left_cum(cand, mu_fp, slope) <= quant)
            s_sym = torch.where(ok, cand, s_sym)
        left = _left_cum(s_sym, mu_fp, slope)
        nxt = _left_cum(torch.clamp(s_sym + 1, max=SYM_MAX), mu_fp, slope)
        prob = torch.where(s_sym >= SYM_MAX, (1 << PRECISION) - left, nxt - left)

        # ---- advance and renormalise the active streams
        n_lo_hi, n_lo_lo, n_rg_hi, n_rg_lo, renorm = _advance(lo_hi, lo_lo, scale, left, prob)
        ren = active & renorm
        nw = torch.gather(flat_words, 2, cur.clamp(max=R - 1)[..., None])[..., 0]
        nw = torch.where(cur < R, nw, 0)   # past the buffer: zero padding
        lo_hi = torch.where(active, n_lo_hi, lo_hi)
        lo_lo = torch.where(active, n_lo_lo, lo_lo)
        rg_hi = torch.where(active, n_rg_hi, rg_hi)
        rg_lo = torch.where(active, n_rg_lo, rg_lo)
        pt_hi = torch.where(ren, pt_lo, pt_hi)
        pt_lo = torch.where(ren, nw, pt_lo)
        cur = cur + ren.to(i64)

        store.scatter_(1, pos, torch.where(active, s_sym, 0))

    grid = store[:, :n_store].reshape(G, h + 4, wp)[:, 4:, 4:w + 4]
    return grid.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# numpy models of the kernel's arithmetic shortcuts, for the tests: each
# repeats what csrc/wavefront_decode.cu computes and reports whether the
# bounds stated there hold, so that the tests can hold it against tpu_cdf
# and the plain version above.
# ---------------------------------------------------------------------------
def _in_i32(x: np.ndarray) -> bool:
    return bool(((x >= -(1 << 31)) & (x < (1 << 31))).all())


def exp2_neg24_32_model(t) -> tuple[np.ndarray, bool]:
    """exp2_neg24_32 of the kernel for t = a * b < 2^40: (exp2(-t/2^24) in
    X.24 as int64, whether the bounds its source states hold: |r| < 2^25,
    |r * f| < 2^49, |r * f + C * 2^24| < 2^50, each step's result in
    int32). A step is (r * f + C * 2^24) >> 24, as the kernel computes it."""
    t = np.asarray(t, np.int64)
    ok = bool(((t >= 0) & (t < (1 << 40))).all())
    f = t & _QMAX
    q = np.minimum(t >> PRECISION, 31)
    r = np.full(t.shape, EXP2_POLY[6], np.int64)
    for k in range(5, -1, -1):
        ok &= bool((np.abs(r) < (1 << 25)).all())
        prod = r * f
        fused = prod + (EXP2_POLY[k] << PRECISION)
        ok &= bool((np.abs(prod) < (1 << 49)).all() and (np.abs(fused) < (1 << 50)).all())
        r = fused >> PRECISION
        ok &= _in_i32(r)
    return np.clip(r, 0, 1 << PRECISION) >> q, ok


def left_cum_32_model(k, mu_fp, slope) -> tuple[np.ndarray, bool]:
    """left_cum_32 of the kernel for symbol k + SYM_MIN, k in [0, 127]:
    (value, whether |m| < 2^16, slope < 2^24 and the Horner bounds hold)."""
    k, mu_fp, slope = (np.asarray(a, np.int64) for a in (k, mu_fp, slope))
    m = (k + SYM_MIN) * 256 - 128 - mu_fp
    ok = bool((np.abs(m) < (1 << 16)).all() and ((slope >= 0) & (slope < (1 << 24))).all())
    e, ok_e = exp2_neg24_32_model(np.abs(m) * slope)
    half = e >> 1
    cdf = np.where(m < 0, half, (1 << PRECISION) - half)
    v = ((FREE_WEIGHT * cdf) >> PRECISION) + k * LEAK_STEP
    return np.where(k <= 0, 0, v), ok and ok_e


def team_search_model(quant, mu_fp, slope) -> tuple[np.ndarray, ...]:
    """The kernel's symbol search: two 8-ary rounds (strides 16, 2; cut point
    i of a round is evaluated by member i mod T), then left_cum at base,
    base + 1, base + 2. Returns (symbol, left, prob)."""
    quant = np.asarray(quant, np.int64)
    base = np.zeros(quant.shape, np.int64)
    for st in (16, 2):
        cnt = np.zeros_like(base)
        for i in range(8):
            cnt += left_cum_32_model(base + i * st, mu_fp, slope)[0] <= quant
        base += (cnt - 1) * st
    v = [left_cum_32_model(np.minimum(base + i, 127), mu_fp, slope)[0] for i in range(3)]
    up = v[1] <= quant
    k = base + up
    left = np.where(up, v[1], v[0])
    prob = np.where(k == 127, (1 << PRECISION) - left, np.where(up, v[2], v[1]) - left)
    return k + SYM_MIN, left, prob


def quantile_model(t, scale) -> tuple[np.ndarray, np.ndarray]:
    """quantile() of the kernel: min(t // scale, 2^24 - 1) for uint64 t and
    scale in [2^8, 2^40), from an FP64 reciprocal estimate corrected by one
    exact step. Returns (quotient, estimate's offset from it after the
    clamp), the offset being -1, 0 or 1 where the source's bound holds."""
    t = np.asarray(t, np.uint64)
    scale = np.asarray(scale, np.uint64)
    qd = np.minimum(t.astype(np.float64) * (1.0 / scale.astype(np.float64)), float(_QMAX))
    q0 = qd.astype(np.uint64)
    down = q0 * scale > t              # q0 <= 2^24 - 1: no product reaches 2^64
    up = ~down & (q0 < _QMAX) & ((q0 + np.uint64(1)) * scale <= t)
    q = np.where(down, q0 - np.uint64(1), np.where(up, q0 + np.uint64(1), q0))
    return q.astype(np.int64), q0.astype(np.int64) - q.astype(np.int64)


# ---------------------------------------------------------------------------
# Host packing (the counterpart of pallas_decode.decode_grids_pallas).
# ---------------------------------------------------------------------------
def shear_src(h: int, w: int) -> np.ndarray:
    """[D * 128] int32 map from (wavefront d, lane) to the raster pixel
    y * w + x it decodes, with h * w as the sentinel of an idle lane."""
    step = tpu_wavefront_step(w)
    d = np.arange(n_wavefronts(h, w))[:, None]
    lane = np.arange(LANES)[None, :]
    y_lo = np.maximum(0, (d - w + step) // step)
    y_hi = np.minimum(h - 1, d // step)
    y = y_lo + ((lane - y_lo) % LANES)
    x = d - step * y
    return np.where(y <= y_hi, y * w + x, h * w).astype(np.int32).reshape(-1)


def pack_int16_pairs(ctx: np.ndarray) -> np.ndarray:
    """[..., n] int (certified |v| < 2^15) -> [..., ceil(n/2)] int32 with
    feature 2k in the low half-word and 2k+1 in the high half-word."""
    ctx = np.asarray(ctx, np.int64)
    if ctx.shape[-1] % 2:
        ctx = np.concatenate([ctx, np.zeros(ctx.shape[:-1] + (1,), np.int64)], -1)
    packed = (ctx[..., 0::2] & 0xFFFF) | ((ctx[..., 1::2] & 0xFFFF) << 16)
    return packed.astype(np.uint32).view(np.int32)


def arm8_flat(arm8: dict) -> tuple[np.ndarray, ...]:
    """tpu_cdf.arm8_from_int_layers params -> flat int32 (wtr, btr, stw, stb)."""
    wtr = np.concatenate([np.asarray(m, np.int32).reshape(-1)
                          for m in arm8["trunk_weights"]])
    btr = np.concatenate([np.asarray(b, np.int32).reshape(-1)
                          for b in arm8["trunk_biases"]])
    return (wtr, btr, np.asarray(arm8["stab_weight"], np.int32).reshape(-1),
            np.asarray(arm8["stab_bias"], np.int32).reshape(-1))


def pack_jobs(jobs: list[dict], h: int, w: int, n_ifce: int,
              ifce_packed: bool = False) -> dict:
    """Pack same-shape jobs {"words": 128 u32 arrays, "arm8": X.8 params,
    "ifce": [h*w, n_ifce] int or None} into the kernel's numpy inputs."""
    G = len(jobs)
    R = words_bucket(max(2, max(len(ws) for j in jobs for ws in j["words"])))
    words = np.zeros((R, G, LANES), np.uint32)
    flat = [arm8_flat(j["arm8"]) for j in jobs]
    rows = max((n_ifce + 1) // 2 if ifce_packed else n_ifce, 1)
    ifce = np.zeros((n_wavefronts(h, w), rows, G, LANES), np.int32)
    src = shear_src(h, w)
    for g, job in enumerate(jobs):
        for s, ws in enumerate(job["words"]):
            words[: len(ws), g, s] = ws
        if n_ifce > 0:
            ctx = np.asarray(job["ifce"], np.int64)
            if ifce_packed:
                ctx = pack_int16_pairs(ctx)
            padded = np.concatenate([ctx, np.zeros((1, ctx.shape[1]), ctx.dtype)])
            ifce[:, :, g, :] = padded[src].reshape(-1, LANES, rows).transpose(0, 2, 1)
    return {"words": words.view(np.int32),
            "wtr": np.stack([f[0] for f in flat]), "btr": np.stack([f[1] for f in flat]),
            "stw": np.stack([f[2] for f in flat]), "stb": np.stack([f[3] for f in flat]),
            "ifce": ifce}


def decode_grids(jobs: list[dict], h: int, w: int, ctx_idx: np.ndarray, n_ifce: int,
                 device: str | torch.device = "cuda", ifce_packed: bool = False,
                 plain: bool = False) -> list[np.ndarray]:
    """Decode a batch of same-shape, same-architecture [h, w] grids (each job
    as in pack_jobs; weights, payloads and IFCE contexts may differ). plain
    runs the plain version on the device instead of the kernel. Returns the
    int64 grids in job order."""
    from coolchic_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    arrays = pack_jobs(jobs, h, w, n_ifce, ifce_packed)
    t = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    dims = tuple((int(m.shape[0]), int(m.shape[1]))
                 for m in jobs[0]["arm8"]["trunk_weights"])
    kw = dict(h=h, w=w, taps=_tap_list(ctx_idx), dims=dims, n_ifce=n_ifce,
              ifce_packed=ifce_packed)
    fn = wavefront_decode_plain if plain else wavefront_decode
    out = fn(t["words"], t["wtr"], t["btr"], t["stw"], t["stb"], t["ifce"], **kw)
    return [g.astype(np.int64) for g in out.cpu().numpy()]
