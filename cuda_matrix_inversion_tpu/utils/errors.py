"""Fail-fast assertion layer.

Reference counterpart: ``include/helper_cpu.h:6-28`` — ``fail``/``ensure``
printf-and-exit macros with errno, plus ``div_ceil``.  This build raises
typed exceptions instead of ``exit(1)`` so callers (pytest, long-running
services) can recover; the benchmark CLIs convert them to exit codes at the
top level, preserving the reference's fail-fast CLI behavior.
"""

from __future__ import annotations


class EnsureError(AssertionError):
    """Raised when an ``ensure`` invariant fails (ref ``helper_cpu.h:12-21``)."""


def fail(fmt: str, *args) -> None:
    """Unconditional failure (ref ``fail`` macro, ``helper_cpu.h:6-10``)."""
    raise EnsureError(fmt % args if args else fmt)


def ensure(cond, fmt: str = "ensure failed", *args) -> None:
    """Invariant check (ref ``ensure`` macro, ``helper_cpu.h:12-21``)."""
    if not cond:
        fail(fmt, *args)


def div_ceil(a: int, b: int) -> int:
    """Ceiling division (ref ``helper_cpu.h:23-28``)."""
    return -(-a // b)
