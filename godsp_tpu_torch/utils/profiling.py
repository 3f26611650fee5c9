"""Tracing and profiling hooks.

Counterpart of godsp_tpu/utils/profiling.py (SURVEY.md §5: the reference
has none), over torch.profiler instead of jax.profiler:

    with trace_to("/tmp/godsp-trace"):
        with annotate("pwelch-chunk"):
            sp.update(block)

trace_to records the CPU and, where there is a card, its CUDA kernels,
and writes a Chrome trace (chrome://tracing, Perfetto) into log_dir;
the profile object it yields also answers key_averages() for the
kernels' device time by name.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace_to", "annotate", "start_server"]

log = logging.getLogger("godsp_tpu_torch.profiling")


@contextlib.contextmanager
def trace_to(log_dir: str, create_perfetto_link: bool = False) -> Iterator[torch.profiler.profile]:
    """Capture a host (+ device, where CUDA is present) trace of the
    enclosed block into log_dir as a Chrome trace JSON file.  Yields the
    torch.profiler.profile, whose key_averages() sums the events by name.
    create_perfetto_link is accepted for godsp_tpu's signature: the file
    opens in Perfetto as it is."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        log.info("profile trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span in the trace timeline (torch.profiler.record_function),
    plus an NVTX range when CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def start_server(port: int = 9999) -> Optional[object]:
    """godsp_tpu starts jax's on-demand profiler server here.  torch has no
    such server: this logs a warning and returns None, as the JAX function
    does on a backend without one; use trace_to."""
    log.warning("profiler server unavailable on torch (port %d): use trace_to", port)
    return None
