"""Aux subsystems: profiling and tracing, debug checks."""

from zsgnet_tpu_torch.utils.profiling import Timer, flops_estimate, profile_trace, time_fn  # noqa: F401
