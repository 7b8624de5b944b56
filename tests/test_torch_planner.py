"""The port's planner facade against the reference's: `plan()` gives the
reference's solutions bit for bit for every builtin solver, the result and
option types round-trip through JSON, the registry behaves the same, every
named scenario builds the reference's arrays (the TPU fleet too, from the
bridge's TPU tier catalog, and plans on it are the reference's), the
planning CLI prints the reference CLI's JSON, both names of the batched
allocator engine run the torch tier, and the `risk=` post-pass gives the
reference's counts. Numpy on both sides, apart from the risk hook (torch on
the CPU)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

import repro.planner as ref_planner
from repro import core as ref_core
from repro_torch import core, planner
from repro_torch.planner import (EngineUnavailableError, PlanOptions,
                                 PlanRequest, PlanResult, SolverSpec,
                                 UnknownSolverError, plan, register_solver,
                                 scenario, solver_names, unregister_solver)
from repro_torch.planner.specs import FleetSpec, ScenarioSpec, WorkloadSpec

torch.set_num_threads(1)

# tests/test_planner_api.py's five instances, built by the same constructor
# and seed on both sides (bit-identical, as tests/test_torch_core.py pins).
INSTANCES = {
    "default": lambda m: m.default_instance(),
    "random-6-6-10": lambda m: m.random_instance(6, 6, 10, seed=1),
    "random-8-5-6": lambda m: m.random_instance(8, 5, 6, seed=2),
    "stressed-1.15": lambda m: m.default_instance().stressed(1.15),
    "tight-budget": lambda m: m.random_instance(6, 6, 10, seed=4,
                                                budget=40.0),
}
FIELDS = ("x", "y", "q", "w", "z", "u")


def _assert_bitwise_equal(a, b, label):
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), \
            f"{label}: field {f} differs"


# ---------------------------------------------------------------------------
# Facade == the reference's facade, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(INSTANCES))
@pytest.mark.parametrize("solver", ["gh", "agh", "lpr", "dvr", "hf"])
def test_plan_bitwise_equals_reference(name, solver):
    opts = dict(time_limit=120.0) if solver == "lpr" else {}
    got = plan(solver, instance=INSTANCES[name](core),
               options=PlanOptions(**opts))
    want = ref_planner.plan(solver, instance=INSTANCES[name](ref_core),
                            options=ref_planner.PlanOptions(**opts))
    _assert_bitwise_equal(got.solution, want.solution, f"{solver}/{name}")
    assert got.objective == want.objective
    assert got.cost_breakdown == want.cost_breakdown
    assert got.slack == want.slack
    assert got.violations == want.violations
    assert got.feasible == want.feasible
    assert got.options == want.options
    assert got.solution.method == want.solution.method
    if solver != "lpr":     # lpr reports nothing; agh counts work done
        assert got.diagnostics == want.diagnostics


def test_plan_milp_bitwise_equals_reference():
    """MILP on tests/test_planner_api.py's own MILP instance: HiGHS proves
    optimality there in well under a second. On the five instances above it
    runs into any time limit (20-60 s each), where the incumbent depends on
    the wall clock, so bit-identity could not be asked of it."""
    opts = dict(time_limit=120.0)
    got = plan("milp", instance=core.random_instance(3, 3, 4, seed=3),
               options=PlanOptions(**opts))
    want = ref_planner.plan("milp",
                            instance=ref_core.random_instance(3, 3, 4, seed=3),
                            options=ref_planner.PlanOptions(**opts))
    assert got.diagnostics == want.diagnostics
    assert got.diagnostics["status"] == "DM"
    _assert_bitwise_equal(got.solution, want.solution, "milp")
    assert got.objective == want.objective
    assert plan("dm", instance=core.random_instance(3, 3, 4, seed=3),
                options=PlanOptions(**opts)).solver == "milp"


def test_facade_equals_direct_calls():
    inst = core.random_instance(6, 6, 10, seed=1)
    for solver, fn in (("gh", core.gh), ("agh", core.agh), ("dvr", core.dvr),
                       ("hf", core.hf)):
        _assert_bitwise_equal(plan(solver, instance=inst).solution, fn(inst),
                              solver)
    opts = PlanOptions(restarts=2, patience=3, seed=5,
                       local_search="batched-rescan", workers=0)
    direct = core.agh(inst, R=2, patience=3, seed=5,
                      local_search="batched-rescan", workers=0)
    _assert_bitwise_equal(plan("agh", instance=inst, options=opts).solution,
                          direct, "agh/options")


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["xla", "torch"])
def test_batched_allocator_engines_run_the_torch_tier(engine):
    """Both names run the lane-batched tier: with device="cpu" here, and
    with no device (CUDA) it raises where CUDA is absent."""
    inst = core.random_instance(6, 6, 10, seed=1)
    res = plan("agh", instance=inst, engine=engine,
               options=PlanOptions(device="cpu"))
    assert res.diagnostics["engine"] == "torch"
    assert res.solution.method == "AGH-TORCH"
    assert res.options["engine"] == engine
    direct = core.agh(inst)
    assert res.objective <= core.objective(inst, direct) + 1e-9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            plan("agh", instance=inst, engine=engine)
    assert issubclass(EngineUnavailableError, RuntimeError)
    assert core.EngineUnavailableError is EngineUnavailableError


def test_unknown_engine_is_a_value_error():
    with pytest.raises(ValueError, match="unknown engine"):
        plan("agh", instance=core.default_instance(), engine="simplex")


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_registry_names_match_reference():
    assert solver_names() == ref_planner.solver_names()


def test_unknown_solver_lists_registered_names():
    with pytest.raises(UnknownSolverError) as ei:
        plan("aghh", instance=core.default_instance())
    msg = str(ei.value)
    for name in ("gh", "agh", "milp", "lpr", "dvr", "hf", "aghh"):
        assert name in msg


def test_register_custom_solver_roundtrip():
    def _noop(inst, options, warm_start):
        return core.gh(inst), {"custom": True}

    spec = SolverSpec("custom-test", _noop, "test-only solver")
    register_solver(spec)
    try:
        assert "custom-test" in solver_names()
        res = plan("custom-test", instance=core.default_instance())
        assert res.diagnostics["custom"] is True
        with pytest.raises(ValueError, match="already registered"):
            register_solver(spec)
    finally:
        unregister_solver("custom-test")
    assert "custom-test" not in solver_names()
    with pytest.raises(ValueError, match="already registered"):
        register_solver(SolverSpec("gh", lambda i, o, w: None, "clash"))


def test_overwrite_clears_stale_alias():
    def _custom(inst, options, warm_start):
        return core.gh(inst), {"custom_dm": True}

    register_solver(SolverSpec("dm", _custom, "test"), overwrite=True)
    try:
        res = plan("dm", instance=core.default_instance())
        assert res.diagnostics.get("custom_dm") is True
        assert res.solver == "dm"
    finally:
        unregister_solver("dm")
        from repro_torch.planner.registry import _ALIASES
        _ALIASES["dm"] = "milp"
    assert plan("dm", instance=core.random_instance(3, 3, 4, seed=3),
                options=PlanOptions(time_limit=60.0)).solver == "milp"


# ---------------------------------------------------------------------------
# PlanResult / PlanOptions / PlanRequest
# ---------------------------------------------------------------------------

def test_plan_result_json_round_trip():
    res = plan("agh", instance=core.default_instance())
    res2 = PlanResult.from_json(res.to_json())
    _assert_bitwise_equal(res2.solution, res.solution, "json")
    for f in ("objective", "cost_breakdown", "slack", "violations",
              "diagnostics", "options", "feasible"):
        assert getattr(res2, f) == getattr(res, f), f
    assert res.summary()["solver"] == "agh"
    # The reference reads the port's JSON, and the other way round.
    ref = ref_planner.PlanResult.from_json(res.to_json())
    assert ref.to_dict() == res.to_dict()


def test_plan_options_round_trip():
    opts = PlanOptions(restarts=4, ablation=frozenset({"no_m1"}),
                       order=(2, 0, 1), risk={"S": 8, "device": "cpu"})
    assert PlanOptions.from_dict(opts.to_dict()) == opts
    assert opts.to_dict() == ref_planner.PlanOptions(
        restarts=4, ablation=frozenset({"no_m1"}), order=(2, 0, 1),
        risk={"S": 8, "device": "cpu"}).to_dict()


def test_plan_request_validation():
    inst = core.default_instance()
    with pytest.raises(ValueError, match="exactly one"):
        plan(PlanRequest(solver="gh"))
    with pytest.raises(ValueError, match="exactly one"):
        plan(PlanRequest(solver="gh", instance=inst,
                         scenario="paper-default"))
    with pytest.raises(ValueError, match="not both"):
        plan(PlanRequest(solver="gh", instance=inst), instance=inst)


# ---------------------------------------------------------------------------
# Scenario specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ref_planner.SCENARIOS))
def test_named_scenarios_build_reference_arrays(name):
    got = scenario(name, n_windows=16).build()
    want = ref_planner.scenario(name, n_windows=16).build()
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b), f"{name}: {f.name}"
        elif isinstance(b, (int, float, str, list, tuple)) or b is None:
            assert a == b, f"{name}: {f.name}"
    spec = scenario(name, n_windows=16)
    ref_spec = ref_planner.scenario(name, n_windows=16)
    assert np.array_equal(spec.demand_path(got), ref_spec.demand_path(want))
    sched = spec.fault_schedule(got, n_windows=16)
    ref_sched = ref_spec.fault_schedule(want, n_windows=16)
    assert sched.change_points(got.K) == ref_sched.change_points(want.K)


def _assert_instances_equal(got, want, label):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b), f"{label}: {f.name}"
        elif isinstance(b, (int, float, str, list, tuple)) or b is None:
            assert a == b, f"{label}: {f.name}"


def _dryrun_rows() -> list[dict]:
    """A synthetic dry-run JSON in the fields `launch/dryrun.py` writes:
    rows the calibration reads, and rows it must skip (failed, not the
    decode shape, multi-pod, an arch it does not map)."""
    rows = []
    for i, arch in enumerate(["qwen2-0.5b", "qwen2-1.5b", "rwkv6-7b",
                              "deepseek-7b", "internvl2-26b", "qwen2-72b"]):
        rows.append(dict(arch=arch, shape="decode_32k", multi_pod=False,
                         status="ok", n_devices=256,
                         hlo_bytes_per_device=3.1e9 * (i + 1) ** 1.7,
                         params_active=0.5e9 * (i + 1) ** 2))
    rows += [
        dict(arch="qwen2-0.5b", shape="decode_32k", multi_pod=False,
             status="error", n_devices=256, hlo_bytes_per_device=1.0,
             params_active=1.0),
        dict(arch="qwen2-1.5b", shape="prefill_32k", multi_pod=False,
             status="ok", n_devices=256, hlo_bytes_per_device=9e12,
             params_active=1.5e9),
        dict(arch="deepseek-7b", shape="decode_32k", multi_pod=True,
             status="ok", n_devices=512, hlo_bytes_per_device=9e12,
             params_active=7e9),
        dict(arch="kimi-k2-1t-a32b", shape="decode_32k", multi_pod=False,
             status="ok", n_devices=256, hlo_bytes_per_device=5e12,
             params_active=3.2e10),
        # a tiny row: the ratio clips at its floor of 0.25
        dict(arch="qwen2-72b", shape="decode_32k", multi_pod=False,
             status="ok", n_devices=256, hlo_bytes_per_device=1.0,
             params_active=7.2e10)]
    return rows


def test_tpu_fleet_is_registered_and_builds(tmp_path):
    """The TPU tier catalog (`core/bridge.py`): the registry is the
    reference's, an unknown catalog raises, `tpu_instance` and
    `calibrate_from_dryrun` give the reference's instances."""
    from repro.core import bridge as ref_bridge
    from repro_torch.core import bridge
    assert sorted(planner.SCENARIOS) == sorted(ref_planner.SCENARIOS)
    with pytest.raises(ValueError, match="catalog"):
        ScenarioSpec(fleet=FleetSpec(catalog="asic")).build()
    assert bridge.TPU_TIERS == ref_bridge.TPU_TIERS
    for name, make in INSTANCES.items():
        _assert_instances_equal(bridge.tpu_instance(make(core)),
                                ref_bridge.tpu_instance(make(ref_core)),
                                f"tpu/{name}")
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(_dryrun_rows()))
    arch_to_model = {"qwen2-0.5b": 0, "qwen2-1.5b": 1, "rwkv6-7b": 2,
                     "deepseek-7b": 3, "internvl2-26b": 4, "qwen2-72b": 5}
    got = bridge.calibrate_from_dryrun(
        bridge.tpu_instance(core.default_instance()), str(path),
        arch_to_model)
    want = ref_bridge.calibrate_from_dryrun(
        ref_bridge.tpu_instance(ref_core.default_instance()), str(path),
        arch_to_model)
    assert not np.array_equal(want.B, ref_core.default_instance().B)
    _assert_instances_equal(got, want, "calibrated")
    empty = tmp_path / "empty.json"
    empty.write_text("[]")
    inst = core.default_instance()
    assert bridge.calibrate_from_dryrun(inst, str(empty), arch_to_model) \
        is inst
    pair = bridge.PairDeployment("m", "v5e-bf16", 4, 2, 8, {})
    assert (bridge.DeploymentSpec([pair]).mesh_shape_for(pair)
            == ref_bridge.DeploymentSpec([]).mesh_shape_for(
                ref_bridge.PairDeployment("m", "v5e-bf16", 4, 2, 8, {})))


@pytest.mark.parametrize("solver", ["gh", "agh"])
def test_tpu_fleet_plans_equal_reference(solver):
    from repro_torch.core.bridge import TPU_TIERS
    got = plan(solver, scenario="tpu-fleet")
    want = ref_planner.plan(solver, scenario="tpu-fleet")
    _assert_bitwise_equal(got.solution, want.solution, f"tpu-fleet/{solver}")
    assert got.objective == want.objective
    assert got.cost_breakdown == want.cost_breakdown
    inst = scenario("tpu-fleet").build()
    assert [t[0] for t in TPU_TIERS] == inst.tier_names
    assert inst.tp_degrees == [1, 2, 4, 8, 16]


@pytest.mark.parametrize("tiers", ["gpu", "tpu"])
@pytest.mark.parametrize("method", ["agh", "gh", "hf", "lpr", "dvr"])
def test_plan_cli_json_equals_reference(tiers, method, tmp_path, capsys):
    """`python -m repro_torch.launch.plan` prints (and writes to --out) the
    reference CLI's JSON, apart from the solver's wall time."""
    from repro.launch import plan as ref_cli
    from repro_torch.launch import plan as cli
    dry = tmp_path / "dryrun.json"
    dry.write_text(json.dumps(_dryrun_rows()))
    outs = []
    for mod, out in ((cli, tmp_path / "port.json"),
                     (ref_cli, tmp_path / "ref.json")):
        argv = ["--method", method, "--tiers", tiers, "--budget", "90",
                "--seed", "1", "--out", str(out)]
        if tiers == "tpu":
            argv += ["--calibrate", str(dry)]
        assert mod.main(argv) == 0
        printed = json.loads(capsys.readouterr().out)
        written = json.loads(out.read_text())
        assert printed == written
        written.pop("runtime_s")
        outs.append(written)
    assert outs[0] == outs[1]
    assert len(outs[0]["unmet"]) == core.default_instance().I


def test_synthetic_scenario_and_plan_by_name():
    spec = ScenarioSpec(workload=WorkloadSpec(family="synthetic",
                                              I=6, J=6, K=10), seed=1)
    assert np.array_equal(spec.build().lam,
                          core.random_instance(6, 6, 10, seed=1).lam)
    res = plan("gh", scenario="budget-tight")
    want = ref_planner.plan("gh", scenario="budget-tight")
    _assert_bitwise_equal(res.solution, want.solution, "budget-tight")
    with pytest.raises(KeyError, match="paper-default"):
        scenario("no-such-scenario")


# ---------------------------------------------------------------------------
# The risk= post-pass
# ---------------------------------------------------------------------------

_COUNTS = ("S", "n_anchor0", "n_harvest_exact", "n_pdhg", "n_fallback_exact",
           "n_anchors")


def test_plan_risk_hook_matches_reference():
    pytest.importorskip("jax")
    res = plan("gh", instance=core.random_instance(10, 8, 8, seed=7),
               options=PlanOptions(risk={"S": 64, "engine": "pdhg",
                                         "device": "cpu"}))
    want = ref_planner.plan(
        "gh", instance=ref_core.random_instance(10, 8, 8, seed=7),
        options=ref_planner.PlanOptions(risk={"S": 64, "engine": "pdhg"}))
    got, ref = res.diagnostics["risk"], want.diagnostics["risk"]
    assert set(got) == set(ref)
    for k in _COUNTS:
        assert got[k] == ref[k], k
    assert got["n_anchor0"] + got["n_harvest_exact"] == 64
    for k, v in ref.items():
        if k not in _COUNTS and k != "wall_s" and isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-12), k
    base = plan("gh", instance=core.random_instance(10, 8, 8, seed=7))
    assert "risk" not in base.diagnostics
    assert base.objective == res.objective


def test_plan_risk_hook_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    inst = core.random_instance(10, 8, 8, seed=7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan("gh", instance=inst, options=PlanOptions(risk={"S": 8}))
    # The exact engine has no device and runs anywhere.
    res = plan("gh", instance=inst,
               options=PlanOptions(risk={"S": 8, "engine": "exact"}))
    assert res.diagnostics["risk"]["engine"] == "exact"
