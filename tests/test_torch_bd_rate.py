"""Is the port's intra RD gap against the JAX encoder a bug or noise?
(ROADMAP.md Queue 3.) Slow; run once, results recorded there.

kodim15 (192x128, lop, the debug recipe, no RDOQ) at the rate points
4e-4, 1e-3, 2e-3 and 4e-3 (four, so that the cubic fit of the Bjontegaard
delta is determined), seeds 0, 1 and 2. Each seed is ONE mixed-λ batched
encode in each package (encode_images_batched, the four rate points as the
four slots of the same image), so both packages run the same pipeline and
differ only in their noise streams and float summation order. The
verdict: the port's BD-rate against JAX's (both curves averaged over the
seeds) must not exceed the seed-to-seed spread of either package alone
(the largest |BD-rate| between two seeds of one package).
"""

import itertools
import warnings

import numpy as np
import pytest
import torch

from coolchic_tpu.io.images import read_png
from coolchic_tpu.parallel.encode_batch import encode_images_batched as j_encode_batched
from coolchic_tpu.train.presets import PresetDebug as JPresetDebug
from coolchic_tpu.utils.parsecli import INTRA_OPERATING_POINTS
from coolchic_tpu.utils.parsecli import coolchic_config_from_args as j_cfg_from_args
from coolchic_tpu_torch.io.io import load_frame_data_from_file
from coolchic_tpu_torch.parallel.encode_batch import encode_images_batched
from coolchic_tpu_torch.train.presets import PresetDebug
from coolchic_tpu_torch.utils.parsecli import coolchic_config_from_args, intra_operating_points
from coolchic_tpu_torch.utils.results import bd_rate

pytestmark = pytest.mark.slow
torch.set_num_threads(2)

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
IMG = str(REPO / "tests/data/192x128_kodim15.png")
LMBDAS = [4e-4, 1e-3, 2e-3, 4e-3]
SEEDS = [0, 1, 2]


def _curves(tmp_path):
    p_frame = load_frame_data_from_file(IMG)
    j_frame = read_png(IMG)
    p_cfgs = {"residue": coolchic_config_from_args(intra_operating_points()["lop"],
                                                   p_frame.img_size)}
    j_cfgs = {"residue": j_cfg_from_args(INTRA_OPERATING_POINTS["lop"], j_frame.img_size)}
    kw = dict(lmbda=LMBDAS[0], start_lr=1e-2, itr_main_training=1)
    curves = {"port": [], "jax": []}
    for seed in SEEDS:
        paths = [str(tmp_path / f"p{seed}_{i}.cool") for i in range(len(LMBDAS))]
        res = encode_images_batched([p_frame] * len(LMBDAS), p_cfgs, PresetDebug(**kw), paths,
                                    seed=seed, verbose=False, rdoq=False, lmbdas=LMBDAS,
                                    device="cpu")
        curves["port"].append(([r["rate_bpp"] for r in res], [r["psnr_db"] for r in res]))
        paths = [str(tmp_path / f"j{seed}_{i}.cool") for i in range(len(LMBDAS))]
        res = j_encode_batched([j_frame] * len(LMBDAS), j_cfgs, JPresetDebug(**kw), paths,
                               seed=seed, verbose=False, rdoq=False, lmbdas=LMBDAS)
        curves["jax"].append(([r["rate_bpp"] for r in res], [r["psnr_db"] for r in res]))
    return curves


def test_port_bd_rate_within_seed_spread(tmp_path):
    curves = _curves(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", np.exceptions.RankWarning)
        mean = {k: (np.mean([c[0] for c in v], axis=0), np.mean([c[1] for c in v], axis=0))
                for k, v in curves.items()}
        port_vs_jax = bd_rate(*mean["port"], *mean["jax"])
        per_seed = [bd_rate(*p, *j) for p, j in zip(curves["port"], curves["jax"])]
        spread = {k: max(abs(bd_rate(*a, *b)) for a, b in itertools.permutations(v, 2))
                  for k, v in curves.items()}
    for k, v in curves.items():
        for seed, (rate, psnr) in zip(SEEDS, v):
            print(f"{k} seed {seed}: " + ", ".join(
                f"λ {lam:g}: {p:.3f} dB {r:.4f} bpp" for lam, r, p in zip(LMBDAS, rate, psnr)))
    print(f"BD-rate port vs JAX (seed-averaged curves): {port_vs_jax:+.2f} %; per seed "
          + ", ".join(f"{b:+.2f}" for b in per_seed)
          + f" %; seed-to-seed spread: port {spread['port']:.2f} %, JAX {spread['jax']:.2f} %")
    assert np.isfinite(port_vs_jax)
    assert abs(port_vs_jax) <= max(spread.values()), (port_vs_jax, spread)
