"""Sample drivers of the port, run as `python -m coolchic_tpu_torch.samples.<name>`:
getcodingstruct, encode, encode_batch, encode_sweep, encode_kodak_batch and
decode_batch (the ports of samples/*.py). Each runs on the torch device
given by --device (cuda, the default, or cpu)."""

import argparse

# The JAX drivers' --cpu picks the JAX platform; the port takes --device.
_NO_JAX_FLAGS = "--cpu selects the JAX package's platform: pass --device cpu."


def add_device_args(p: argparse.ArgumentParser) -> None:
    """--device, and the JAX drivers' --cpu, refused by check_device_args."""
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    p.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)


def check_device_args(p: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    if args.cpu:
        p.error(_NO_JAX_FLAGS)
