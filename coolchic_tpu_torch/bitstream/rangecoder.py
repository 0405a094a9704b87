"""ctypes binding to the host C++ range coder (csrc/rangecoder.cpp, built
with g++ into the port's build directory at first use).

The native library implements a constriction-0.4.2-compatible queue range
coder (u64 state, u32 words, 24-bit quantized-Laplace leaky model over
[-64, 63]) plus a full-grid wavefront codec with the int64 fixed-point ARM
inlined, so decoding one latent grid is a single native call.

Reference parity: coolchic/bitstream/component/rangecoder.py (constriction
wrapper) and latent.py (wavefront loop).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from coolchic_tpu_torch.core.constants import N_POSSIBLE_MU, N_POSSIBLE_SCALE
from coolchic_tpu_torch.utils.build import build_shared_library

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "rangecoder.cpp"
_DATA = Path(__file__).resolve().parent / "data"


def _load() -> ctypes.CDLL:
    path = build_shared_library(
        _SRC, "coolchic_rc",
        ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"])
    lib = ctypes.CDLL(str(path))

    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    lib.rc_set_tables.argtypes = [p, i64, p, i64]
    lib.rc_enc_new.restype = p
    lib.rc_enc_free.argtypes = [p]
    lib.rc_enc_n_words_sealed.argtypes = [p]
    lib.rc_enc_n_words_sealed.restype = i64
    lib.rc_enc_get_words_sealed.argtypes = [p, p]
    lib.rc_dec_new.argtypes = [p, i64]
    lib.rc_dec_new.restype = p
    lib.rc_dec_free.argtypes = [p]
    lib.rc_code_grid.argtypes = [p, ctypes.c_int32] + [ctypes.c_int32] * 4 + [p] \
        + [ctypes.c_int32] + [p] * 5
    lib.rc_code_grid.restype = ctypes.c_int32
    lib.rc_code_grid_streams.argtypes = [p, ctypes.c_int32, ctypes.c_int32,
                                          ctypes.c_int32] \
        + [ctypes.c_int32] * 4 + [p] + [ctypes.c_int32] + [p] * 5
    lib.rc_code_grid_streams.restype = ctypes.c_int32

    lib.rc_arm_forward.argtypes = [p, i64, ctypes.c_int32, ctypes.c_int32,
                                   p, p, p, p, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32, p]
    lib.rc_arm_forward.restype = ctypes.c_int32
    return lib


_lib: ctypes.CDLL | None = None


def load_mu_scale_tables() -> tuple[np.ndarray, np.ndarray]:
    table = np.load(_DATA / "mu_scale.npy").astype(np.float32)
    mu = table[:N_POSSIBLE_MU]
    scale = table[N_POSSIBLE_MU:]
    assert scale.size == N_POSSIBLE_SCALE
    return mu, scale


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
        mu, scale = load_mu_scale_tables()
        _lib.rc_set_tables(
            mu.ctypes.data_as(ctypes.c_void_p), mu.size,
            scale.ctypes.data_as(ctypes.c_void_p), scale.size,
        )
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class RangeEncoder:
    """Streaming range encoder; encode symbols then read the sealed stream."""

    def __init__(self) -> None:
        self._lib = get_lib()
        self._h = self._lib.rc_enc_new()

    def get_bytes(self) -> bytes:
        n = self._lib.rc_enc_n_words_sealed(self._h)
        out = np.empty(n, dtype=np.uint32)
        self._lib.rc_enc_get_words_sealed(self._h, _ptr(out))
        return out.tobytes()

    def handle(self) -> int:
        return self._h

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rc_enc_free(self._h)
            self._h = None


class RangeDecoder:
    def __init__(self, raw: bytes) -> None:
        self._lib = get_lib()
        self._words = np.frombuffer(raw, dtype=np.uint32).copy()
        self._h = self._lib.rc_dec_new(_ptr(self._words), self._words.size)

    def handle(self) -> int:
        return self._h

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rc_dec_free(self._h)
            self._h = None


def arm_forward_native(x: np.ndarray, arm_fp: dict, output_shift: int,
                       act_shift: int = 16) -> np.ndarray:
    """Batched fixed-point ARM forward in C++ (int64 matmuls are slow in
    numpy). x: [B, C] int64 raw contexts -> [B, n_out] int64. act_shift 16 =
    reference X.16 pipeline, 8 = tpu-profile X.8 pipeline."""
    lib = get_lib()
    x = np.ascontiguousarray(x, dtype=np.int64)
    n, dim = x.shape
    n_out = arm_fp["stab_weight"].shape[1]
    weights = np.concatenate([np.ascontiguousarray(wi, dtype=np.int64).reshape(-1)
                              for wi in arm_fp["trunk_weights"]])
    biases = np.concatenate([np.ascontiguousarray(bi, dtype=np.int64).reshape(-1)
                             for bi in arm_fp["trunk_biases"]])
    stab_w = np.ascontiguousarray(arm_fp["stab_weight"], dtype=np.int64)
    stab_b = np.ascontiguousarray(arm_fp["stab_bias"], dtype=np.int64)
    out = np.empty((n, n_out), dtype=np.int64)
    err = lib.rc_arm_forward(_ptr(x), n, dim, len(arm_fp["trunk_weights"]),
                             _ptr(weights), _ptr(biases), _ptr(stab_w), _ptr(stab_b),
                             n_out, output_shift, act_shift, _ptr(out))
    if err != 0:
        raise RuntimeError(f"rc_arm_forward failed with error {err}")
    return out


def code_grid(coder, is_encode: bool, h: int, w: int, n_spatial_ctx: int,
              ifce_ctx: np.ndarray | None, arm_fp: "dict", ctx_flat_idx: np.ndarray,
              data: np.ndarray | None = None) -> np.ndarray:
    """Encode or decode one [h, w] latent grid in normative wavefront order.

    arm_fp: dict with keys trunk_weights (list of [in, out] int64, already
    transposed and residual-folded), trunk_biases, stab_weight [C, 2],
    stab_bias [2] -- see coolchic_tpu_torch.bitstream.fixedpoint.
    """
    lib = get_lib()
    n_ifce = 0 if ifce_ctx is None else int(ifce_ctx.shape[-1])
    if ifce_ctx is None:
        ifce_arr = np.zeros((0,), dtype=np.int64)
    else:
        ifce_arr = np.ascontiguousarray(ifce_ctx.reshape(h * w, n_ifce), dtype=np.int64)

    weights = np.concatenate([np.ascontiguousarray(wi, dtype=np.int64).reshape(-1)
                              for wi in arm_fp["trunk_weights"]])
    biases = np.concatenate([np.ascontiguousarray(bi, dtype=np.int64).reshape(-1)
                             for bi in arm_fp["trunk_biases"]])
    stab_w = np.ascontiguousarray(arm_fp["stab_weight"], dtype=np.int64)
    stab_b = np.ascontiguousarray(arm_fp["stab_bias"], dtype=np.int64)
    ctx_flat_idx = np.ascontiguousarray(ctx_flat_idx, dtype=np.int32)

    if is_encode:
        buf = np.ascontiguousarray(data, dtype=np.int64).reshape(h * w).copy()
        handle = coder.handle()
    else:
        buf = np.zeros(h * w, dtype=np.int64)
        handle = coder.handle()

    err = lib.rc_code_grid(
        handle, 1 if is_encode else 0, h, w, n_spatial_ctx, n_ifce,
        _ptr(ifce_arr) if n_ifce else None,
        len(arm_fp["trunk_weights"]),
        _ptr(weights), _ptr(biases), _ptr(stab_w), _ptr(stab_b),
        _ptr(ctx_flat_idx), _ptr(buf),
    )
    if err != 0:
        raise RuntimeError(f"rc_code_grid failed with error {err}")
    return buf.reshape(h, w)


def code_grid_streams(coders: list, is_encode: bool, h: int, w: int, n_spatial_ctx: int,
                      ifce_ctx: np.ndarray | None, arm_fp: "dict",
                      ctx_flat_idx: np.ndarray,
                      data: np.ndarray | None = None, model: int = 1) -> np.ndarray:
    """`tpu`-profile variant of code_grid: the pixel at row y is coded on
    stream y % len(coders) (row-keyed; wavefront pixels have distinct
    consecutive rows, so one wavefront touches each stream at most once and
    a decoder can retire a whole wavefront in parallel -- threads on the card,
    threads on host)."""
    lib = get_lib()
    n_ifce = 0 if ifce_ctx is None else int(ifce_ctx.shape[-1])
    if ifce_ctx is None:
        ifce_arr = np.zeros((0,), dtype=np.int64)
    else:
        ifce_arr = np.ascontiguousarray(ifce_ctx.reshape(h * w, n_ifce), dtype=np.int64)

    weights = np.concatenate([np.ascontiguousarray(wi, dtype=np.int64).reshape(-1)
                              for wi in arm_fp["trunk_weights"]])
    biases = np.concatenate([np.ascontiguousarray(bi, dtype=np.int64).reshape(-1)
                             for bi in arm_fp["trunk_biases"]])
    stab_w = np.ascontiguousarray(arm_fp["stab_weight"], dtype=np.int64)
    stab_b = np.ascontiguousarray(arm_fp["stab_bias"], dtype=np.int64)
    ctx_flat_idx = np.ascontiguousarray(ctx_flat_idx, dtype=np.int32)

    if is_encode:
        buf = np.ascontiguousarray(data, dtype=np.int64).reshape(h * w).copy()
    else:
        buf = np.zeros(h * w, dtype=np.int64)

    handles = (ctypes.c_void_p * len(coders))(*[c.handle() for c in coders])
    err = lib.rc_code_grid_streams(
        handles, len(coders), 1 if is_encode else 0, model, h, w, n_spatial_ctx, n_ifce,
        _ptr(ifce_arr) if n_ifce else None,
        len(arm_fp["trunk_weights"]),
        _ptr(weights), _ptr(biases), _ptr(stab_w), _ptr(stab_b),
        _ptr(ctx_flat_idx), _ptr(buf),
    )
    if err != 0:
        raise RuntimeError(f"rc_code_grid_streams failed with error {err}")
    return buf.reshape(h, w)
