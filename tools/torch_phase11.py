#!/usr/bin/env python3
"""chip_smoke.py's phase 11 (reproducibility) alone, on one card, in about
5 minutes:

    python tools/torch_phase11.py

It builds the minimal phases 5, 8, 10c and 10d that phase 11 reads (phase
5's intra CLI on the first of the repo's 8 kodim14 frames; phase 8's clip
encoded as I0 then P2, the file copied after each; phase 10c's whole
2048x3072 encode of that frame tiled 4 x 4; phase 10d's batched encode of
the first 2 frames alone) and calls chip_smoke.reproducibility_phase.
Prints its JSON on the last line. Imports no JAX.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # before CUDA starts

import glob  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from coolchic_tpu_torch import cc_encode
    from coolchic_tpu_torch.bitstream.decode import decode_video
    from coolchic_tpu_torch.io.framedata import FrameData
    from coolchic_tpu_torch.io.io import save_frame_data_to_file
    from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
    from coolchic_tpu_torch.train.presets import PresetDebug
    from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, \
        intra_operating_points

    t0 = time.time()
    dev = torch.device("cuda", 0)
    print(cs.card_line(), f"torch {torch.__version__}", flush=True)
    files = sorted(glob.glob(str(ROOT / "results/round5/kodak/*.cool")))[:8]
    frames = [decode_video(f, device=dev)["0"] for f in files]
    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp)
        p5, p8, p10 = wd / "p5", wd / "p8", wd / "p10"
        for p in (p5, p8, p10):
            p.mkdir()
        save_frame_data_to_file(frames[0], str(p5 / "target.ppm"))
        cs.run_cli(dev, "5", ["-i", str(p5 / "target.ppm"), *cs.INTRA_ARGV], p5)
        h, w = frames[0].img_size
        clip = p8 / f"clip_{w}x{h}_60p_yuv420_8b.yuv"
        cs.synthetic_clip(frames[0], clip)
        for idx, extra, copy in ((0, ["--no_rdoq"], "i_only.cool"), (1, [], "ip_only.cool")):
            rc = cc_encode.main([*cs.video_cli_argv(clip, p8 / "out.cool", p8 / "w"),
                                 "--coding_idx", str(idx), *extra])
            cs.check(rc == 0, f"cc_encode coding index {idx} exited {rc}")
            shutil.copy(p8 / "out.cool", p8 / copy)
        f0 = frames[0]
        big = FrameData(f0.bitdepth, f0.frame_data_type,
                        np.ascontiguousarray(np.tile(np.asarray(f0.data), (1, 1, 4, 4))))
        save_frame_data_to_file(big, str(p10 / "big.ppm"))
        r = cs.encode_big(dev, p10 / "big.ppm", p10 / "enc_whole")
        (p10 / "whole.cool").write_bytes(r["payload"])
        cfgs = {"residue": coolchic_config_from_args(intra_operating_points()["hop"],
                                                     frames[0].img_size)}
        encode_images_batched(frames[:2], cfgs,
                              PresetDebug(lmbda=1e-3, start_lr=1e-2, itr_main_training=1),
                              [str(p10 / f"first_2_alone{k}.cool") for k in range(2)],
                              seed=0, verbose=False, rdoq=False, profile="tpu", device=dev)
        print(f"set-up {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        out = cs.reproducibility_phase(dev, frames, p5, p8, p10, wd / "p11")
        print(f"phase 11 {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"reproducibility": out, "card": cs.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
