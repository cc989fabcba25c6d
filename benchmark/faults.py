"""Faults planted under a training cell's timed path, for the tests and the
calibration of its output check: each puts a broken step in the program's
place (``fault(driver, trainer, host, draws) -> step``), which the check has
to refuse."""

from __future__ import annotations


def unchanged(driver, trainer, host, draws):
    """A step that returns its state unchanged: no optimizer steps."""
    trainer.opt.step = lambda grads: True
    return driver.step_fn(trainer, host, draws)


def half_batch(driver, trainer, host, draws):
    """Half of the batch left out, the mean taken over the rest."""
    return driver.step_fn(trainer, host, draws, rows=host[0].shape[0] // 2)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
