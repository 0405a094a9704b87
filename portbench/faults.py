"""Faults planted under a run's timed path, to show that the check reads
them (portbench/tests and tools/control.py): each is a context manager
that patches the program and restores it."""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def state_unchanged():
    """Every training step returns its parameters and optimizer state as
    it got them."""
    from coolchic_tpu_torch.train.train import PhaseFns

    return _patched(PhaseFns, "step",
                    lambda orig: lambda self, leaves, states, *a, **k: (leaves, states))


def half_batch():
    """The training loss leaves out the second half of the batch and takes
    the mean over the rest (each slot's loss is summed into the gradient)."""
    from coolchic_tpu_torch.train.train import PhaseFns

    def make(orig):
        def loss(self, *a, **k):
            lo = orig(self, *a, **k)
            h = max(lo.loss.shape[0] // 2, 1)
            kept = lo.loss.clone()
            kept[:h] = lo.loss[:h] / h
            kept[h:] = 0.0 * lo.loss[h:]
            return lo._replace(loss=kept)
        return loss

    return _patched(PhaseFns, "loss", make)


def altered_symbol():
    """The wavefront decode returns one latent symbol of the first image,
    in the middle of its grid, one higher than decoded."""
    from coolchic_tpu_torch.ops import wavefront_decode as wfd

    def make(orig):
        def decode(*a, **k):
            out = orig(*a, **k).clone()
            out[0, out.shape[1] // 2, out.shape[2] // 2] += 1
            return out
        return decode

    return _patched(wfd, "wavefront_decode", make)
