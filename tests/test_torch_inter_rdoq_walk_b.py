"""The whole P/B quantization walk with RDOQ against the JAX package's
(tests/test_torch_inter_rdoq_walk.py), for the B frame."""

import pytest

from tests.test_torch_inter_rdoq_walk import walk_matches_jax


@pytest.mark.parametrize("frame_type", ["B"])
def test_inter_rdoq_walk_matches_jax(frame_type):
    walk_matches_jax(frame_type)
