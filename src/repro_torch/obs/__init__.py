"""Observability: typed task timelines and their Perfetto export.

The port's copies of the reference's ``repro/obs`` for both
schedulers.  The megakernel's trace ring (``trace=True``) records one
``desc.TRACE_WORDS`` record per grid slot (per pop under the dynamic
scheduler); :func:`decode_ring` turns it
into a :class:`TaskTrace`, :func:`check_event_order` checks it against
the descriptor table's event words, and :func:`chrome_trace` exports it
as JSON that Perfetto (https://ui.perfetto.dev) loads.
"""
from .perfetto import chrome_trace, validate_chrome_trace, write_chrome_trace
from .trace import (KIND_NAMES, TaskEvent, TaskTrace, check_event_order,
                    decode_ring, sequential_trace)

__all__ = [
    "TaskEvent", "TaskTrace", "KIND_NAMES",
    "decode_ring", "sequential_trace", "check_event_order",
    "chrome_trace", "validate_chrome_trace", "write_chrome_trace",
]
