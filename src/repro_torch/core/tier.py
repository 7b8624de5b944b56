"""The allocator's batched tier on the card — for now only its error.

The reference runs AGH's multi-start as jitted XLA programs
(`engine="xla"`); the port's counterpart, `engine="torch"`, is still to be
ported (ROADMAP item 3) and will load from this module. Until then the
planner facade raises `EngineUnavailableError` for either engine name.
"""
from __future__ import annotations


class EngineUnavailableError(RuntimeError):
    """Raised when `plan()` is asked for an allocator engine this package
    cannot run: the message names the engine and why."""


__all__ = ["EngineUnavailableError"]
