#!/usr/bin/env python3
"""Which ops make a training step of the PyTorch port differ run to run on
a card, before and after the port's determinism repair.

    python tools/torch_determinism_probe.py      # on a machine with a card

Every path of chip_smoke.training_paths (the n = 1 I step, P and B steps,
a G = 8 batched window at 512x768, a 2048x3072 step on 2 row shards, the
serial Wasserstein trainer; the frames are the repo's 8 kodim14 `ref`
bitstreams decoded) runs
  - under torch.use_deterministic_algorithms(True, warn_only=True), the
    warnings recorded, and under (True): does any op raise? "before" puts
    back torch's F.pad(mode="replicate") and the advanced-indexing nearest
    resize that coolchic_tpu_torch.ops.convs.replicate_pad and
    ops/resize.py's expand / 0-1 matrix resize replaced; "after" is the
    port as it is;
  - three times from one seed at cuDNN's default algorithms and with
    cudnn.deterministic, with the old ops and the new: the largest
    difference of the parameters it ends on between runs 1 and 2, 1 and 3.
Prints one JSON line per path. Imports no JAX.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # before CUDA starts

import glob  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from coolchic_tpu_torch.bitstream.decode import decode_video
    from coolchic_tpu_torch.models import coolchic, synthesis
    from coolchic_tpu_torch.ops import convs, resize

    new = (convs.replicate_pad, coolchic.interpolate)

    def old_interpolate(x, size, mode):
        h_in, w_in = x.shape[-2:]
        if mode == "nearest" and tuple(size) not in ((h_in, w_in), (2 * h_in, 2 * w_in)):
            iy = resize._on(resize._nearest_index_np, h_in, size[0], x.device)
            ix = resize._on(resize._nearest_index_np, w_in, size[1], x.device)
            return x[..., iy, :][..., :, ix]
        return new[1](x, size, mode)

    def use(old: bool):
        pad = (lambda x, p: F.pad(x, p, mode="replicate")) if old else new[0]
        convs.replicate_pad = synthesis.replicate_pad = pad
        coolchic.interpolate = old_interpolate if old else new[1]

    def diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    dev = torch.device("cuda", 0)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": chip_smoke.card_line()}), flush=True)
    files = sorted(glob.glob(str(ROOT / "results/round5/kodak/*.cool")))[:8]
    images = np.concatenate([np.asarray(decode_video(f, device=dev)["0"].data, np.float32)
                             for f in files])
    big = np.ascontiguousarray(np.tile(images[:1], (1, 1, 4, 4)))
    for name, fn in chip_smoke.training_paths(dev, images, big).items():
        rec = {}
        t0 = time.time()
        use(True)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            fn()
        rec["warn_only, before"] = sorted({str(w.message)[:200] for w in ws})
        for tag, old in (("strict, before", True), ("strict, after", False)):
            use(old)
            torch.use_deterministic_algorithms(True)
            try:
                fn()
                rec[tag] = "ok"
            except RuntimeError as e:
                rec[tag] = str(e)[:300]
        torch.use_deterministic_algorithms(False)
        for tag, det, old in (("cudnn default, old ops", False, True),
                              ("cudnn det, old ops", True, True),
                              ("cudnn default, new ops", False, False),
                              ("cudnn det, new ops", True, False)):
            use(old)
            torch.backends.cudnn.deterministic = det
            a, b, c = fn(), fn(), fn()
            rec["repeat: " + tag] = [diff(a, b), diff(a, c)]
        torch.backends.cudnn.deterministic = True
        use(False)
        torch.cuda.synchronize()
        rec["seconds"] = time.time() - t0
        print(json.dumps({name: rec}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
