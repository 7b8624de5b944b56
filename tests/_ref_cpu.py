"""The JAX reference pinned to the CPU, for the port's tests.

A port test module that computes the reference's answer in its own process
imports this module before it imports jax or `repro`: the import pins jax
to its CPU backend (`pin()`) whatever devices the machine has. On a
machine with a card jax would otherwise take the card's backend, and the
reference's numbers would differ from the CPU's in the last bits. `pin()`
does not import jax itself, so the gloo workers that import a test module
never do. If jax has already started a backend other than the CPU's in
this process, `pin()` raises, and the module fails to import: the
reference's numbers would come from that device.
"""
from __future__ import annotations

import os
import sys

PLATFORM = "cpu"


def pin() -> None:
    """Pin jax's platform to the CPU for this process and its children:
    `JAX_PLATFORMS`, and jax's own setting where jax is imported already."""
    os.environ["JAX_PLATFORMS"] = PLATFORM
    if "jax" in sys.modules:
        pin_imported(sys.modules["jax"])


def pin_imported(jax) -> None:
    """`jax.config`'s platforms set to the CPU, or, where a backend has
    started already, a check that every started backend is the CPU's."""
    from jax._src import xla_bridge
    if xla_bridge.backends_are_initialized():
        check_started({b.platform for b in xla_bridge.backends().values()},
                      jax.default_backend())
        return
    jax.config.update("jax_platforms", PLATFORM)


def check_started(platforms: set[str], default: str) -> None:
    """Raise unless the started backends are the CPU's only."""
    if platforms != {PLATFORM} or default != PLATFORM:
        raise RuntimeError(
            f"jax started the {sorted(platforms)} backends (default "
            f"{default!r}) before the reference was pinned to the CPU; run "
            f"the port's tests with JAX_PLATFORMS=cpu or in a process of "
            f"their own")


pin()
