"""Observability: throughput counters + profiler hooks.

The reference has no tracing/profiling at all (SURVEY.md §5 — commented-out
couts). This is the accelerator equivalent: walker-updates/s and ESS/s counters for
runs, and a thin wrapper over ``jax.profiler`` for device traces.
"""

import contextlib
import time

import numpy as np


class ThroughputMonitor:
    """Accumulates wall-time and update counts; reports updates/s & ESS/s.

    Usage::

        mon = ThroughputMonitor(n_walkers=W)
        with mon.measure(steps=1000):
            sampler.run_mcmc(1000)
        print(mon.updates_per_s)
        print(mon.ess_per_s(sampler.get_samples()))
    """

    def __init__(self, n_walkers):
        self.n_walkers = int(n_walkers)
        self.seconds = 0.0
        self.steps = 0

    @contextlib.contextmanager
    def measure(self, steps):
        t0 = time.perf_counter()
        yield self
        self.seconds += time.perf_counter() - t0
        self.steps += int(steps)

    @property
    def updates(self):
        return self.steps * self.n_walkers

    @property
    def updates_per_s(self):
        return self.updates / self.seconds if self.seconds else 0.0

    def ess_per_s(self, samples, **kw):
        """ESS/s per parameter over the measured window (NaN if τ never
        converged — see analysis.ess)."""
        from mcmcpp_tpu.analysis import effective_sample_size

        ess = np.asarray(effective_sample_size(samples, **kw), np.float64)
        return ess / self.seconds if self.seconds else ess * 0.0


@contextlib.contextmanager
def trace_profile(log_dir):
    """Capture a device trace viewable in TensorBoard/XProf.

    ≙ the tracing subsystem the reference lacks (SURVEY.md §5).
    """
    import jax

    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
