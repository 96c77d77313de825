"""Utility layer: observability/metrics (accelerator-side stand-in for the
reference's ``MCMCpp/Utility`` grab-bag; the allocation/deleter pieces live
in ``native/``, PRNG plumbing in ``ops/random.py``)."""

from mcmcpp_tpu.utils.metrics import ThroughputMonitor, trace_profile

__all__ = ["ThroughputMonitor", "trace_profile"]
