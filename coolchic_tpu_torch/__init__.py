"""coolchic_tpu_torch: the PyTorch + CUDA port of coolchic_tpu.

It decodes Cool-Chic 5.0.1 bitstreams in both profiles (`ref` and `tpu`).
The `tpu`-profile latent grids are range-decoded on an NVIDIA Hopper card
by a hand-written CUDA kernel (csrc/wavefront_decode.cu); the float tail
(learned upsampling, synthesis, final rescale) runs as PyTorch ops.

Every entry point takes `device` and defaults to "cuda". Without a card it
raises; the CPU is used only when the caller passes device="cpu".
"""

import torch

__version__ = "0.1.0"

# Full-f32 float tail, as the JAX package pins (coolchic_tpu/__init__.py):
# cuDNN would otherwise run the synthesis convs in TF32 on the card.
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
