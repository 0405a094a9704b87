"""The multi-process run (parallel/dcn.py) on the CPU: two processes,
two mesh devices each, the gloo backend, one process group over
tcp://localhost. worker_main checks, in every process, a batched training
window over the process-spanning batch (all images' latents finite after
an all-gather) and the 9-frame GOP's five waves with each decoded
reference arriving bit for bit in the other process. A worker that fails
or hangs fails the launch inside the test's own timeout."""

import pytest

from coolchic_tpu_torch.parallel.dcn import launch_dcn_dryrun


def test_two_process_dcn_dryrun():
    outs = launch_dcn_dryrun(n_devices=4, num_processes=2, device="cpu", backend="gloo",
                             timeout=300)
    assert len(outs) == 2
    for rank, out in enumerate(outs):
        assert f"dcn worker {rank}/2: OK (4 global devices, 5 waves, gloo on cpu)" in out


def test_dcn_refusals():
    with pytest.raises(ValueError, match="backend"):
        launch_dcn_dryrun(n_devices=4, num_processes=2, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="do not split"):
        launch_dcn_dryrun(n_devices=3, num_processes=2, device="cpu", backend="gloo")
    from coolchic_tpu_torch.parallel.dcn import init_multiprocess
    with pytest.raises(ValueError, match="nccl"):
        init_multiprocess("localhost:1", 2, 0, local_devices=1, device="cpu",
                          backend="nccl")
