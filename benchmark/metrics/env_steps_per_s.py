"""All the window's env steps, each iteration's with its K gradient
steps, over all of the window's time (host clock, closed by a device
synchronize)."""

from benchmark.harness.stats import rate


def read(run):
    return rate(run.window.env_steps, run.window.seconds)
