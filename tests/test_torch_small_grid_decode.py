"""The small-grid decode (coolchic_tpu_torch/ops/small_grid_decode.py): the
grids coded on fewer than 128 streams, decoded by the batch's device path,
against the host C++ range decoder and the JAX package's host decode, bit
for bit.

Inputs: one `tpu`-profile file of each configuration of the port's
benchmark (portbench/data/hop, portbench/data/lop: 10-grid ladders at
512x768 whose levels 2-9 are coded on 8 or 1 streams, level 2 with IFCE
inputs), and a 128x192 file of the repo transcoded to the `tpu` profile,
whose grids of width 6 and 3 are coded in raster order and stay on the
host route.

The JAX package is imported inside the test that uses it, so that the
card's test also runs where JAX is not installed:
    python -m pytest --noconftest tests/test_torch_small_grid_decode.py -m cuda
"""

import glob
from pathlib import Path

import numpy as np
import pytest
import torch

from coolchic_tpu_torch.bitstream import codec
from coolchic_tpu_torch.bitstream import headers as ph
from coolchic_tpu_torch.bitstream.device_decode import _parse_level_blocks, prepare_batch
from coolchic_tpu_torch.bitstream.nncodec import decode_network
from coolchic_tpu_torch.core.constants import non_zero_pixel_ctx_index
from coolchic_tpu_torch.ops import small_grid_decode as sgd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
POOL = {c: sorted(glob.glob(str(REPO / f"portbench/data/{c}/*.cool"))) for c in ("hop", "lop")}
REF_FILE = sorted(glob.glob(str(REPO / "results/round4/h2h_kodim15_v3/*.cool")))[0]


def _item(raw: bytes) -> tuple:
    """(header, bytes_nn, bytes_latent) of a one-frame file."""
    if raw.startswith(ph.TPU_PROFILE_MAGIC):
        raw = raw[len(ph.TPU_PROFILE_MAGIC):]
    _, rest = ph.VideoHeader.read(raw)
    _, rest = ph.FrameHeader.read(rest)
    ch, rest = ph.CoolChicHeader.read(rest)
    return ch, rest[:ch.nn_n_bytes], rest[ch.nn_n_bytes:ch.nn_n_bytes + ch.n_bytes_latent]


def _transcoded_item(path: str) -> tuple:
    """A `ref`-profile file's latents coded again in the `tpu` profile, at
    the profile's own stream counts."""
    ch, bnn, blat = _item(Path(path).read_bytes())
    _, grids = codec.decode_coolchic(ch, bnn, blat, profile="ref", device="cpu")
    nn = decode_network(bnn, ch.to_config(), ch.nn_q_step_shift, ch.nn_expgol_cnt,
                        ch.nn_n_bit_pad)
    pay = codec.encode_coolchic_latents(ch, nn, [np.asarray(g, np.int64) for g in grids],
                                        profile="tpu")
    return ch, bnn, pay


def _host_grids(item, levels) -> dict:
    """The port's host C++ decode of `levels` (coarse to fine, each with all
    coarser levels among them)."""
    ch, bnn, blat = item
    cfg = ch.to_config()
    nn = decode_network(bnn, cfg, ch.nn_q_step_shift, ch.nn_expgol_cnt, ch.nn_n_bit_pad)
    arm8 = codec._main_arm_params(nn, ch, cfg, 1)
    blocks = _parse_level_blocks(cfg, blat)
    out: dict = {}
    for level in levels:
        out[level] = codec.decode_tpu_level_host(
            nn, cfg, ch, arm8, level, blocks[level]["words"],
            [out[lv] for lv in range(level + 1, cfg.n_latent_grids)])
    return out


def _jax_host_grids(item, levels) -> dict:
    """The JAX package's host decode of `levels`, as its decode_coolchic
    decodes a `tpu`-profile grid (codec.decode_coolchic_batched's host
    route), level by level."""
    from coolchic_tpu.bitstream import codec as jcodec
    from coolchic_tpu.bitstream import headers as jh
    from coolchic_tpu.bitstream import rangecoder as jrc
    from coolchic_tpu.bitstream.device_decode import _parse_level_blocks as j_blocks
    from coolchic_tpu.bitstream.nncodec import decode_network as j_decode_network
    from coolchic_tpu.core.constants import non_zero_pixel_ctx_index

    ch, _ = jh.CoolChicHeader.read(item[0].to_bytes())
    bnn, blat = item[1], item[2]
    cfg = ch.to_config()
    nn = j_decode_network(bnn, cfg, ch.nn_q_step_shift, ch.nn_expgol_cnt, ch.nn_n_bit_pad)
    arm8 = jcodec._main_arm_params(nn, ch, cfg, 1)
    blocks = j_blocks(cfg, blat)
    ctx_idx = non_zero_pixel_ctx_index(cfg.spatial_context_arm)
    out: dict = {}
    for level in levels:
        h, w = cfg.size_per_latent[level]
        ifce = jcodec._ifce_context_for_grid(
            nn, cfg, ch, level, [out[lv] for lv in range(level + 1, cfg.n_latent_grids)],
            h, w, model=1)
        decs = [jrc.RangeDecoder(np.asarray(ws).tobytes()) for ws in blocks[level]["words"]]
        out[level] = jrc.code_grid_streams(decs, False, h, w, cfg.spatial_context_arm, ifce,
                                           arm8, ctx_idx, model=1)
    return out


def _small_grids(batch) -> dict:
    """The batch's small grids, decoded by small_grid_decode (the plain
    version on the CPU, the kernel on a card): level -> [G, h, w] int64."""
    decoded = dict(batch.host_grids)
    out = torch.empty(batch.small_out_size, dtype=torch.int32, device=batch.device)
    for run in range(len(batch.small_runs)):
        batch.decode_small_run(run, decoded, out)
    return {lv: decoded[lv].cpu().numpy().astype(np.int64) for lv in batch.small_levels}


@pytest.mark.parametrize("case", ["hop", "lop", "narrow"])
def test_plain_small_grid_decode_matches_host(case):
    """hop, lop: levels 2-9 (8 and 1 streams; level 2 with its IFCE context
    made by the device path) decoded by the plain version == host C++ ==
    the JAX package's host decode. narrow: the grids of width <= 9 are no
    small grids: the batch leaves them to the host route, which decodes
    them as the JAX package does."""
    item = (_transcoded_item(REF_FILE) if case == "narrow"
            else _item(Path(POOL[case][0]).read_bytes()))
    ch, bnn, _ = item
    cfg = ch.to_config()
    batch = prepare_batch([item], device="cpu")
    narrow = tuple(lv for lv in range(cfg.n_latent_grids - 1, -1, -1)
                   if cfg.size_per_latent[lv][1] <= 9)
    assert batch.host_levels == narrow
    if case == "narrow":
        assert narrow == (9, 8, 7, 6)
        n_ifce = cfg.output_feature_ifce
        dim = cfg.spatial_context_arm + n_ifce
        assert not any(sgd.kernel_eligible(*cfg.size_per_latent[lv], 1, dim,
                                           cfg.n_hidden_layers_arm) for lv in narrow)
        nn = decode_network(bnn, cfg, ch.nn_q_step_shift, ch.nn_expgol_cnt, ch.nn_n_bit_pad)
        job = {"h": 4, "w": 6, "words": [np.zeros(2, np.uint32)],
               "arm8": codec._main_arm_params(nn, ch, cfg, 1)}
        with pytest.raises(ValueError, match="does not fit the small-grid decode"):
            sgd.decode_grids([job], non_zero_pixel_ctx_index(cfg.spatial_context_arm), n_ifce,
                             device="cpu")
        got = {lv: batch.host_grids[lv][0].numpy().astype(np.int64) for lv in narrow}
    else:
        assert batch.device_levels == (1, 0) and batch.small_levels == tuple(range(9, 1, -1))
        got = {lv: g[0] for lv, g in _small_grids(batch).items()}
    host = _host_grids(item, tuple(got))
    jax_host = _jax_host_grids(item, tuple(got))
    for lv in got:
        np.testing.assert_array_equal(got[lv], host[lv])
        np.testing.assert_array_equal(got[lv], jax_host[lv])


# Synthetic grids beside the files' ladders: (h, w, n_streams, n_spatial,
# n_ifce, n_hidden). The narrowest grid that is coded by wavefront (w = 10),
# more streams than rows a wavefront (a tall grid), one row, 0 and 1 hidden
# layers, an odd ARM width (11 + 2) and a wide one (32 + 8).
SYNTH = {
    "narrowest": (12, 10, 1, 8, 0, 1),
    "streams_ifce": (20, 33, 8, 12, 2, 2),
    "tall": (70, 12, 8, 14, 6, 2),
    "one_row": (1, 200, 1, 6, 2, 1),
    "hidden0": (16, 24, 1, 8, 0, 0),
    "odd_width": (24, 40, 8, 11, 2, 2),
    "wide_arm": (12, 40, 8, 32, 8, 2),
}


def _synthetic_pair(case: str, seed: int) -> tuple[dict, np.ndarray]:
    """A random grid coded by the host C++ encoder on the case's streams,
    with a random X.8 ARM and a random IFCE context that is a nearest x2
    upsample, as the codec's is: (job for decode_grids, the grid)."""
    from coolchic_tpu_torch.bitstream import rangecoder as rc
    from coolchic_tpu_torch.bitstream.tpu_cdf import arm8_bounds_ok, arm8_from_int_layers

    h, w, n_streams, n_spatial, n_ifce, n_hidden = SYNTH[case]
    rng = np.random.default_rng(seed)
    dim = n_spatial + n_ifce
    w_lim = 40 if n_hidden <= 1 else 10
    layers = [{"weight": rng.integers(-w_lim, w_lim, size=(dim, dim)),
               "bias": rng.integers(-100, 100, size=(dim,))} for _ in range(n_hidden)]
    layers.append({"weight": rng.integers(-60, 60, size=(2, dim)),
                   "bias": rng.integers(-100, 100, size=(2,))})
    stab = {"weight": rng.integers(-20, 20, size=(2, dim)),
            "bias": rng.integers(-50, 50, size=(2,))}
    arm8 = arm8_from_int_layers(layers, -6, -12, stabiliser=stab, subtract_last_layer=True,
                                n_inter_ft_ctx=n_ifce)
    assert arm8_bounds_ok(arm8, np.full(dim, 64.0 * 256.0))
    data = rng.integers(-8, 8, size=(h, w)).astype(np.int64)
    ifce = None
    if n_ifce:
        coarse = rng.integers(-2000, 2000, size=(-(-h // 2), -(-w // 2), n_ifce))
        ifce = np.repeat(np.repeat(coarse, 2, 0), 2, 1)[:h, :w].reshape(h * w, n_ifce)
    encoders = [rc.RangeEncoder() for _ in range(n_streams)]
    rc.code_grid_streams(encoders, True, h, w, n_spatial, ifce, arm8,
                         non_zero_pixel_ctx_index(n_spatial), data=data, model=1)
    words = [np.frombuffer(e.get_bytes(), dtype=np.uint32) for e in encoders]
    return {"h": h, "w": w, "words": words, "arm8": arm8, "ifce": ifce}, data


def _synthetic_decode(case: str, device: str, plain: bool = False) -> None:
    """Two grids of the case with different weights, payloads and contexts
    in one call, each equal to the grid the host C++ encoded."""
    pairs = [_synthetic_pair(case, seed) for seed in (1, 2)]
    _, _, _, n_spatial, n_ifce, _ = SYNTH[case]
    got = sgd.decode_grids([j for j, _ in pairs], non_zero_pixel_ctx_index(n_spatial), n_ifce,
                           device=device, plain=plain)
    for g, (_, data) in zip(got, pairs):
        np.testing.assert_array_equal(g, data)


@pytest.mark.parametrize("case", list(SYNTH))
def test_plain_decodes_synthetic_grids(case):
    _synthetic_decode(case, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SYNTH))
def test_kernel_decodes_synthetic_grids_cuda(case):
    """The kernel and its plain version on the card, on the synthetic grids
    (each ARM width its own library)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    before = sgd.KERNEL.launches
    _synthetic_decode(case, "cuda")
    assert sgd.KERNEL.launches == before + 1
    _synthetic_decode(case, "cuda", plain=True)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["hop", "lop"])
@pytest.mark.parametrize("G", [8, 1])
def test_kernel_matches_plain_and_host_cuda(config, G, monkeypatch):
    """The kernel against its plain version on the card and the host C++,
    on levels 2-9 of G files of the configuration's pool, one launch of
    levels 3-9 and one of level 2 (its IFCE context made on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    items = [_item(Path(p).read_bytes()) for p in POOL[config][:G]]
    batch = prepare_batch(items, device="cuda")
    assert [r[0] for r in batch.small_runs] == [tuple(range(9, 2, -1)), (2,)]
    before = sgd.KERNEL.launches
    got = _small_grids(batch)
    torch.cuda.synchronize()
    assert sgd.KERNEL.launches == before + 2
    # the plain version on the same device inputs
    monkeypatch.setattr(sgd, "small_grid_decode",
                        lambda jobs, *args, **kw: sgd.small_grid_decode_plain(*args, **kw))
    plain = _small_grids(batch)
    assert sgd.KERNEL.launches == before + 2
    for g, item in enumerate(items):
        host = _host_grids(item, batch.small_levels)
        for lv in batch.small_levels:
            np.testing.assert_array_equal(plain[lv][g], host[lv])
            np.testing.assert_array_equal(got[lv][g], host[lv])
