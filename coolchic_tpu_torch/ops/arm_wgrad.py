"""The weight and bias gradient of the ARM's and the IFCE's float linear
layers (models/arm.py:_linear) in training: the CUDA kernel's wrapper and
its plain PyTorch version.

    dW[g] = dY[g]^T . X[g]  [C_out, C_in],   db[g] = dY[g].sum(rows)  [C_out]

for X [G, B, C_in] and dY [G, B, C_out]. It replaces no TPU kernel: the
JAX package leaves this product to XLA, and the port's parent left it to
autograd's backward of torch.baddbmm, a batched cuBLAS GEMM that tiles the
small output with one CTA an image, so that the reduction over B (the
latent pixels of every grid, 524 288 an image at 512x768) ran on G SMs.

The kernel (csrc/arm_wgrad.cu) splits each image's rows over S CTAs, each
streaming its chunk of X and dY once, then adds the S partials in a second
launch, in a fixed order: f32 FMAs on the CUDA cores, no atomics, the same
bits from the same input. What bounds it is bytes: X and dY read once.

S comes from what the wrapper sees, the shapes and the card's SM count:
enough CTAs to fill the card a few times over, each with at least
MIN_CHUNK rows; the kernel sizes its tiles and threads from the widths.
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel (on a copy of X or dY that is not contiguous and
16-byte aligned) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from coolchic_tpu_torch.utils import trace
from coolchic_tpu_torch.utils.build import CudaKernel

MAX_C = 64                  # widest C_in and C_out the kernel takes
CTAS_PER_SM = 4             # pass 1's CTAs an SM holds at once (48 KiB of shared memory each)
MIN_CHUNK = 1024            # fewest rows a CTA of pass 1 sums, against its epilogue


def split(G: int, B: int, n_sm: int) -> tuple[int, int]:
    """(S, chunk): each image's B rows as S chunks of `chunk` rows (the last
    one shorter), G x S CTAs in all, about CTAS_PER_SM a card's SM."""
    want = max(1, -(-CTAS_PER_SM * n_sm // G))
    s = max(1, min(want, B // MIN_CHUNK))
    chunk = -(-B // s)
    return -(-B // chunk), chunk


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it, contiguous and 16-byte aligned (the kernel's loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bytes_read(x: torch.Tensor, dy: torch.Tensor) -> int:
    """What a call must move: X and dY read once."""
    return x.element_size() * (x.numel() + dy.numel())


# csrc/arm_wgrad.cu, one library.
KERNEL = CudaKernel("arm_wgrad", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def n_sm(device: torch.device) -> int:
    """The card's SM count."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def arm_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: autograd's own backward of
    torch.baddbmm(b[:, None], x, w.transpose(1, 2)) for w and b, op for op,
    so that a CPU step's numbers are the parent's bit for bit."""
    return torch.bmm(x.transpose(1, 2), dy).transpose(1, 2), dy.sum(1)


def arm_wgrad(x: torch.Tensor, dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dW [G, C_out, C_in], db [G, C_out]) of X [G, B, C_in] and dY
    [G, B, C_out], on their device."""
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"X {tuple(x.shape)} and dY {tuple(dy.shape)} are not "
                         "[G, B, C_in] and [G, B, C_out]")
    if x.device != dy.device or x.dtype != dy.dtype:
        raise ValueError(f"X ({x.dtype}, {x.device}) and dY ({dy.dtype}, {dy.device}) differ")
    if x.device.type == "cpu":
        return arm_wgrad_plain(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"arm_wgrad runs on cuda or cpu, not {x.device}")
    G, B, ci = x.shape
    co = dy.shape[2]
    if x.dtype != torch.float32:
        raise ValueError(f"the arm_wgrad kernel takes float32, not {x.dtype}")
    if not (0 < ci <= MAX_C and 0 < co <= MAX_C and G > 0):
        raise ValueError(f"C_in {ci}, C_out {co} or G {G} outside the kernel's 1..{MAX_C}")
    x, dy = _aligned(x), _aligned(dy)
    dw = torch.empty((G, co, ci), dtype=x.dtype, device=x.device)
    db = torch.empty((G, co), dtype=x.dtype, device=x.device)
    if B == 0:
        return dw.zero_(), db.zero_()
    S, chunk = split(G, B, n_sm(x.device))
    partial = torch.empty((G, S, co, ci + 1), dtype=x.dtype, device=x.device)
    KERNEL.launch({}, x, dy, partial, dw, db, G, B, ci, co, S, chunk)
    trace.count("train.arm_wgrad.launches", 1)
    if trace.on():
        trace.count("train.arm_wgrad.bytes", bytes_read(x, dy))
    return dw, db
