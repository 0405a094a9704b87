"""Multi-process execution of the batched encoder and the GOP waves.

The reference's only multi-node story is slurm `afterok` chains between
per-frame processes, with decoded reference frames handed off on disk.
The JAX package spans processes with one mesh after
`jax.distributed.initialize` (coolchic_tpu/parallel/dcn.py). The port
spans them with torch.distributed:

  * every process holds a contiguous share of the batch slots and
    advances it with the batched window over its own local data mesh
    (parallel/batch.py), with no collective in the steady state;
  * between GOP waves, each decoded reference reaches every process by a
    broadcast from the rank that decoded it (parallel/gop.py:
    exchange_references), and a gathered array by an all-gather
    (`replicate`): what replaces the reference's disk round-trip.

The process group's backend is always an explicit argument: `gloo` on the
CPU and wherever two ranks share one card (its tensors travel through the
host); `nccl` needs a card of its own for each rank, refuses two ranks on
one card, and has not been run here. `launch_dcn_dryrun` starts the
processes and runs `worker_main`'s two checks:

    python -m coolchic_tpu_torch.parallel.dcn [--n_devices 4] \\
        [--num_processes 2] [--device cuda] [--backend gloo]
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Optional

import torch

BACKENDS = ("gloo", "nccl")


def _local_devices(device: torch.device, process_id: int, local_devices: int,
                   backend: str) -> list:
    """The mesh devices of one process: on cuda with nccl its own card
    (cuda:process_id); with gloo the cards in turn (every rank cuda:0 on a
    one-card machine); on the CPU, `local_devices` entries of the CPU."""
    if device.type != "cuda":
        return [device] * local_devices
    if backend == "nccl":
        return [torch.device("cuda", process_id)] * local_devices
    count = torch.cuda.device_count()
    return [torch.device("cuda", (process_id * local_devices + i) % count)
            for i in range(local_devices)]


def init_multiprocess(coordinator: str, num_processes: int, process_id: int, *,
                      local_devices: int, device: str | torch.device, backend: str) -> list:
    """torch.distributed bring-up at tcp://`coordinator` (host:port);
    returns this process's mesh devices. nccl is refused on the CPU and
    where the ranks outnumber the cards."""
    import torch.distributed as dist

    from coolchic_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs cuda devices; use gloo on the CPU")
        if torch.cuda.device_count() < num_processes:
            raise ValueError(f"nccl needs a card for each of {num_processes} ranks, torch "
                             f"sees {torch.cuda.device_count()}: use gloo when ranks share "
                             f"a card")
        torch.cuda.set_device(process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return _local_devices(dev, process_id, local_devices, backend)


def global_shard(tree, n_global: int, device: torch.device):
    """This process's share of a host-identical stacked nest (leading axis
    n_global): its contiguous slots on `device`, and their (first, last)
    slot. The batched window splits them over the local data mesh."""
    import torch.distributed as dist

    from coolchic_tpu_torch.parallel.batch import _map

    rank, world = dist.get_rank(), dist.get_world_size()
    if n_global % world:
        raise ValueError(f"{n_global} slots do not split over {world} processes")
    k = n_global // world
    a, b = rank * k, (rank + 1) * k
    return _map(lambda x: x[a:b].to(device), tree), (a, b)


def replicate(local: torch.Tensor) -> torch.Tensor:
    """All-gather every process's [k, ...] share (the same k everywhere)
    into [world * k, ...] on every process, in rank order; through the host
    with gloo."""
    import torch.distributed as dist

    on = local.device if dist.get_backend() == "nccl" else torch.device("cpu")
    x = local.detach().to(on).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def worker_main(process_id: int, num_processes: int, coordinator: str, local_devices: int,
                steps: int = 2, *, device: str = "cuda", backend: str) -> None:
    """One process of the dry run (every process runs it alike):

    1. a batched training window over the process-spanning batch (one
       32x32 image a global device; each process its share, over its local
       data mesh), then every process checks ALL images' latents finite
       after an all-gather;
    2. the 9-frame GOP's dependency waves ([1, 1, 1, 2, 4]): frame j of a
       wave is "decoded" (stand-in pixels display_order / 8) by the process
       that owns its slot, and reaches every process through
       exchange_references, where it must arrive bit for bit.
    """
    import torch.distributed as dist

    from coolchic_tpu_torch.models.frame import FrameConfig
    from coolchic_tpu_torch.parallel.batch import (
        Mesh,
        batched_init,
        make_batched_window,
        phase_key,
    )
    from coolchic_tpu_torch.parallel.gop import exchange_references, gop_waves
    from coolchic_tpu_torch.train.presets import TrainerPhase
    from coolchic_tpu_torch.train.train import _frame_phase_generator
    from coolchic_tpu_torch.utils.codingstructure import CodingStructure
    from coolchic_tpu_torch.utils.parsecli import (
        coolchic_config_from_args,
        intra_operating_points,
    )

    devs = init_multiprocess(coordinator, num_processes, process_id,
                             local_devices=local_devices, device=device, backend=backend)
    try:
        assert dist.get_world_size() == num_processes
        n_global = num_processes * local_devices
        local_mesh = Mesh(tuple(devs), len(devs), 1)

        # --- 1. process-spanning batched training window ---------------------
        img_size = (32, 32)
        fcfg = FrameConfig(coolchic_cfg={"residue": coolchic_config_from_args(
            intra_operating_points()["lop"], img_size)})
        phase = TrainerPhase(lmbda=1e-3, max_itr=steps, freq_valid=steps)
        params, opt = batched_init(fcfg, phase, n_global, seed=0, device="cpu")
        targets = torch.linspace(0, 1, 32 * 32).reshape(1, 1, 1, 32, 32).expand(
            n_global, 1, 3, 32, 32)[:, 0]
        mine, (a, b) = global_shard((params, opt, targets), n_global, devs[0])
        window = make_batched_window(fcfg, phase_key(phase), steps, local_mesh)
        keys = [_frame_phase_generator(7, i, 0, d) for i, d in zip(range(a, b), devs)]
        new_params, _, _ = window(mine[0], mine[1], keys, 1e-2, 0.3, 0.2, mine[2])
        lat0 = replicate(new_params["residue"]["latents"][0])
        assert lat0.shape[0] == n_global, lat0.shape
        assert bool(torch.isfinite(lat0).all()), "non-finite latents after the window"

        # --- 2. GOP waves, references exchanged across processes -------------
        cs = CodingStructure(n_frames=9, intra_pos=[0], p_pos=[8])
        waves = gop_waves(cs)
        assert [len(w) for w in waves] == [1, 1, 1, 2, 4], [len(w) for w in waves]
        C, H, W = 3, 8, 8
        decoded: dict = {}
        for wave in waves:
            owners, mine_now = {}, {}
            for slot, f in enumerate(wave):
                g = slot % n_global
                owners[f.display_order] = g // local_devices
                if owners[f.display_order] == process_id:
                    # the stand-in decode runs on the device that owns the slot
                    d = devs[g % local_devices]
                    mine_now[f.display_order] = torch.full(
                        (C, H, W), f.display_order / 8.0, dtype=torch.float32, device=d)
            got = exchange_references(mine_now, [f.display_order for f in wave],
                                      local_mesh, owners=owners)
            for f in wave:
                want = torch.full((C, H, W), f.display_order / 8.0, dtype=torch.float32)
                for x in got[f.display_order].values():
                    assert torch.equal(x.cpu(), want), f"frame {f.display_order} differs"
                decoded[f.display_order] = got[f.display_order]
            for f in wave:
                for r in f.index_references:
                    assert r in decoded, f"reference {r} of frame {f.display_order} missing"
        assert len(decoded) == 9
        dist.barrier()
        print(f"dcn worker {process_id}/{num_processes}: OK ({n_global} global devices, "
              f"{len(waves)} waves, {backend} on {devs[0].type})", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_dcn_dryrun(n_devices: int = 4, num_processes: int = 2, steps: int = 2, *,
                      device: str = "cuda", backend: str, timeout: float = 900) -> list[str]:
    """Start `num_processes` workers (n_devices / num_processes mesh
    devices each) on a free localhost port and wait for them; returns their
    outputs. Raises when a worker fails, prints no OK line, or outlives
    `timeout` seconds (then every worker is killed)."""
    from coolchic_tpu_torch.core.device import resolve_device

    resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if n_devices % num_processes:
        raise ValueError(f"{n_devices} devices do not split over {num_processes} processes")
    local = n_devices // num_processes
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "coolchic_tpu_torch.parallel.dcn", "--process_id", str(i),
         "--num_processes", str(num_processes), "--coordinator", f"localhost:{port}",
         "--local_devices", str(local), "--steps", str(steps), "--device", device,
         "--backend", backend],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(num_processes)]
    deadline = time.time() + timeout
    outs: list[Optional[str]] = [None] * num_processes
    failed = False
    try:
        for i, p in enumerate(procs):
            try:
                outs[i], _ = p.communicate(timeout=max(deadline - time.time(), 1))
            except subprocess.TimeoutExpired:
                failed = True
                break
            failed = failed or p.returncode != 0
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                failed = True
            if outs[i] is None:
                outs[i], _ = p.communicate()
    if failed or not all("OK" in o for o in outs):
        raise RuntimeError(f"dcn dry run failed (timeout {timeout} s):\n"
                           + "\n====\n".join(outs))
    return outs


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--process_id", type=int, default=None,
                    help="run one worker (else launch the dry run's workers)")
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0")
    ap.add_argument("--local_devices", type=int, default=2)
    ap.add_argument("--n_devices", type=int, default=4, help="mesh devices in all")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--backend", default="gloo", choices=BACKENDS,
                    help="gloo (the CPU, or ranks that share a card) or nccl (a card "
                         "for each rank)")
    ap.add_argument("--timeout", type=float, default=900)
    a = ap.parse_args(argv)
    if a.process_id is not None:
        worker_main(a.process_id, a.num_processes, a.coordinator, a.local_devices,
                    steps=a.steps, device=a.device, backend=a.backend)
        return 0
    t0 = time.time()
    outs = launch_dcn_dryrun(a.n_devices, a.num_processes, a.steps, device=a.device,
                             backend=a.backend, timeout=a.timeout)
    for o in outs:
        print(o.strip().splitlines()[-1])
    print(f"dcn dry run: {a.num_processes} processes, {a.n_devices} mesh devices, "
          f"{a.backend} on {a.device}: OK in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
