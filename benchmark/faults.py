"""Faults planted underneath the timed path, to show that the check fails
them: each is a context manager that swaps a function of the port for a
broken one while it is open. The benchmark's runs never open one; the tests
(`benchmark/tests/`) and `benchmark/calibrate.py` do.

  * train `unchanged`: the step computes on a copy of the state and returns
    its metrics, leaving the state as it was;
  * train `half_batch`: the step runs on the first half of the batch, its
    means taken over that half;
  * sample `altered`: each call's first image is negated where the sampler
    returns it;
  * sample `half_batch`: the sampler makes half the batch.
"""

from __future__ import annotations

import contextlib
import copy


@contextlib.contextmanager
def _patched(module, name: str, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _train(wrap):
    from ddgan_torch import train

    def make(make_train_step):
        def broken(*args, **kwargs):
            return wrap(make_train_step(*args, **kwargs))
        return broken

    return _patched(train, "make_train_step", make)


def unchanged():
    def wrap(step):
        def run(state, real, rng, lr_g, lr_d, draws=None):
            return step(copy.deepcopy(state), real, rng, lr_g, lr_d, draws)
        return run

    return _train(wrap)


def half_batch():
    def wrap(step):
        def run(state, real, rng, lr_g, lr_d, draws=None):
            return step(state, real[: real.shape[0] // 2], rng, lr_g, lr_d, draws)
        return run

    return _train(wrap)


def altered():
    from ddgan_torch.cli import test_cli

    def make(make_sampler):
        def broken(*args, **kwargs):
            sample = make_sampler(*args, **kwargs)

            def call():
                x = sample()
                x[0] = -x[0]
                return x
            return call
        return broken

    return _patched(test_cli, "make_sampler", make)


def half_batch_sampler():
    from ddgan_torch.cli import test_cli

    def make(make_sampler):
        def broken(cfg, net, batch, device, rng):
            return make_sampler(cfg, net, batch // 2, device, rng)
        return broken

    return _patched(test_cli, "make_sampler", make)


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
SAMPLE = {"altered": altered, "half_batch": half_batch_sampler}
