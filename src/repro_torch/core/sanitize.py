"""Runtime sanitizer (the reference's ``core/sanitize.py``): three serving
contracts turned into failures at test time instead of quiet latency or
lost repeatability.

* :func:`no_implicit_sync` -- ``torch.cuda.set_sync_debug_mode("error")``
  for the region: any synchronizing CUDA operation (``.item()``, a
  ``.cpu()`` or pageable ``.to()`` copy, ``nonzero``, a boolean-mask
  index, a Python ``if`` on a device bool) raises.  A sync the serving loop
  means to make is named: it runs inside :func:`harvest`, the counterpart
  of the reference's explicit ``jax.device_get``.  On the CPU (no card)
  the guard is inert: nothing there synchronizes with a device.
* :func:`no_new_roots` -- patches ``core.keys.prng_key`` for the region;
  steady-state serving derives every key by split/fold_in from roots made
  at init, so a fresh root inside the loop is an unaudited stream.
* :func:`compile_sentinel` -- the port's only program cache is the CUDA
  libraries of ``kernels/nvcc.py``; the sentinel fails if the region built
  or loaded one (a new program in steady state).
* :func:`steady_state` -- the three composed, for serving-loop tests.

Everything is gated on ``MISS_SANITIZE`` (see :func:`enabled`), so
production code calls :func:`guarded` and :func:`harvest` unconditionally;
with the variable unset they are inert.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch

from . import trace

__all__ = [
    "SanitizerError", "enabled", "no_implicit_sync", "harvest",
    "no_new_roots", "compile_sentinel", "steady_state", "guarded",
]


class SanitizerError(AssertionError):
    """A runtime contract of the serving stack was violated under
    MISS_SANITIZE.  Subclasses AssertionError so pytest reports it as a
    failure, not an error."""


def enabled() -> bool:
    """True when the MISS_SANITIZE environment variable is set truthy."""
    return os.environ.get("MISS_SANITIZE", "").lower() not in (
        "", "0", "false", "off", "no")


def _card() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def _sync_mode(mode: str) -> Iterator[None]:
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


@contextlib.contextmanager
def no_implicit_sync() -> Iterator[None]:
    """Raise on any synchronizing CUDA operation inside the region, except
    inside :func:`harvest`.  The contract is not "no syncs" but "every
    sync is a named harvest point"."""
    if not enabled() or not _card():
        yield
        return
    with _sync_mode("error"):
        yield


@contextlib.contextmanager
def harvest(name: Optional[str] = None) -> Iterator[None]:
    """A named host read (or a host upload that waits for the device):
    allowed inside :func:`no_implicit_sync`.  ``name`` also opens a
    profiler span of that name around it (:func:`.trace.span`)."""
    with trace.span(name) if name is not None else trace.OFF:
        if not enabled() or not _card() \
                or torch.cuda.get_sync_debug_mode() == 0:
            yield
            return
        with _sync_mode("default"):
            yield


@contextlib.contextmanager
def no_new_roots() -> Iterator[None]:
    """Forbid fresh PRNG root construction (``core.keys.prng_key``) inside
    the region: steady-state code derives its keys by split/fold_in from
    the init-time roots."""
    if not enabled():
        yield
        return
    from . import keys

    def _refuse(*a, **k):
        raise SanitizerError(
            "raw PRNG root constructed inside a sanitized region -- "
            "steady-state code must derive keys via keys.split / fold_in "
            "from the init-time roots")

    saved = keys.prng_key
    keys.prng_key = _refuse
    try:
        yield
    finally:
        keys.prng_key = saved


def program_events() -> int:
    """CUDA libraries built or loaded so far in this process."""
    from ..kernels import nvcc
    return nvcc.Library.builds + nvcc.Library.loads


@contextlib.contextmanager
def compile_sentinel(label: str = "program cache") -> Iterator[None]:
    """Fail if a CUDA library was built or loaded inside the region.  Use
    after warmup: a new program in steady state means a per-request value
    reached what selects one."""
    if not enabled():
        yield
        return
    before = program_events()
    yield
    after = program_events()
    if after > before:
        raise SanitizerError(
            f"{label}: {after - before} CUDA librar"
            f"{'y' if after - before == 1 else 'ies'} built or loaded inside "
            f"a steady-state region")


@contextlib.contextmanager
def steady_state() -> Iterator[None]:
    """All three sanitizers composed, for steady-state serving tests."""
    with no_implicit_sync(), no_new_roots(), \
            compile_sentinel(label="steady_state"):
        yield


@contextlib.contextmanager
def guarded() -> Iterator[None]:
    """The production-safe guard: transfer discipline only.  LanePool.tick
    wraps its round in this -- inert unless MISS_SANITIZE is set."""
    with no_implicit_sync():
        yield
