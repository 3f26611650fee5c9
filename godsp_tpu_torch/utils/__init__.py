"""Utilities: timing/metrics, roofline, profiling.

Counterpart of godsp_tpu/utils: the aux-subsystem layer of SURVEY.md §5
(the reference has no tracing, metrics, or observability).  godsp_tpu's
to_host is not ported: it was the TPU's split-plane transfer workaround;
a tensor goes to the host with .cpu().
"""

from godsp_tpu_torch.utils.metrics import BenchResult, roofline, time_fn
from godsp_tpu_torch.utils.profiling import annotate, trace_to

__all__ = ["BenchResult", "roofline", "time_fn", "annotate", "trace_to"]
