"""Optional device profiling (SURVEY.md §5: the reference has only
wall-clock Timer macros; here phase timers plus jax.profiler traces).

Set ``RTC_PROFILE_DIR=/path`` to capture a TensorBoard/Perfetto trace of
every compute phase that passes through ``maybe_trace`` (workflow distance
phases, device engines, bench).  A no-op when unset; when set, a trace that
cannot start raises instead of running the phase untraced.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

ENV_VAR = "RTC_PROFILE_DIR"


@contextmanager
def maybe_trace(phase: str):
    out = os.environ.get(ENV_VAR)
    if not out:
        yield
        return
    import jax
    trace_dir = os.path.join(out, phase.replace(" ", "_"))
    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir):
        yield
