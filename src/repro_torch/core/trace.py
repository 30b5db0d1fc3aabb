"""Host spans of the serving path, visible to ``torch.profiler``.

:func:`span` opens a ``record_function`` span only while a profiler is
recording; otherwise it hands back one shared no-op context, so a span on
the serving path costs one flag check when nobody traces.  Run
``torch.profiler.profile`` around the serving loop and the spans appear in
its trace, on the same clock as the device activity.

Every span name starts ``session.`` or ``lane_pool.``: a trace reader tells
the device-side copies of the spans (``gpu_user_annotation``) from device
work by those prefixes.  A name ending ``.read`` marks a device-to-host
read, ``.upload`` a host-to-device upload that waits for the device.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["OFF", "span"]

OFF = contextlib.nullcontext()
"""The shared no-op context :func:`span` returns with no profiler on."""


def span(name: str):
    """A profiler span named ``name`` while a profiler records, else
    :data:`OFF`."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return OFF
