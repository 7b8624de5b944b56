"""The port's copy of the allocator against the reference package: GH and
AGH give bit-identical plans (q, y, x, objective) on the same instances,
and `to_deployment` the same deployed pairs. Numpy on both sides."""
import dataclasses

import numpy as np
import pytest

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro import core as ref_core
from repro.core import bridge as ref_bridge
from repro_torch import core

INSTANCES = {
    "default": lambda m: m.default_instance(),
    "random-20": lambda m: m.random_instance(20, 20, 20, seed=0),
    "stressed-1.3": lambda m: m.default_instance().stressed(1.3),
    "tight-budget": lambda m: m.random_instance(8, 6, 5, seed=1, budget=15.0),
}


@pytest.mark.parametrize("name", list(INSTANCES))
@pytest.mark.parametrize("solver", ["gh", "agh"])
def test_plans_are_bit_identical(name, solver):
    ref_inst, inst = INSTANCES[name](ref_core), INSTANCES[name](core)
    want = getattr(ref_core, solver)(ref_inst)
    got = getattr(core, solver)(inst)
    for field in ("q", "y", "x"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert core.objective(inst, got) == ref_core.objective(ref_inst, want)
    assert core.is_feasible(inst, got, enforce_zeta=False)
    pairs = [dataclasses.asdict(p) for p in core.to_deployment(inst, got).pairs]
    ref_pairs = [dataclasses.asdict(p) for p in
                 ref_bridge.to_deployment(ref_inst, want).pairs]
    assert pairs == ref_pairs
