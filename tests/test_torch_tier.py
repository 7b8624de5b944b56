"""The port's lane-batched allocator tier (`engine="torch"`,
`repro_torch.core.tier_*`) on the CPU, against the numpy engine and the
reference's `engine="xla"` tier.

Mirrors every test of tests/test_engine_xla.py (dominance over numpy on
the equivalence suite, stats counters, the facade and session surface,
warm starts, batch-width invariance, the numpy default, the hypothesis
property), and adds:

* keys: the phase-2 keys are bitwise numpy's `rank_keys_all` on every
  lane step; on the reference's recorded inputs they equal the jitted
  XLA program's keys at rtol 1e-12 with the same inf positions (XLA on
  the CPU contracts a multiply-add into an FMA, an ulp from numpy), and
  the screen verdicts are identical;
* objectives: tier == reference tier == numpy within 1e-9, same q / w;
* stats: the work counters equal the reference tier's;
* devices: no device means CUDA, which raises where it is absent; GPU
  caps (`avail_gpus`) hand the instance to numpy, as the reference does.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro import core as ref_core
from repro_torch import core
from repro_torch.core import (agh, default_instance, is_feasible, objective,
                              random_instance)
from repro_torch.core import tier_engine, tier_kernels
from repro_torch.core.mechanisms import rank_keys_all
from repro_torch.core.solution import feasibility
from repro_torch.core.tier import agh_torch
from repro_torch.core.tier_tensors import tensors_for
from repro_torch.planner import (EngineUnavailableError, PlanOptions,
                                 PlanSession, plan)

torch.set_num_threads(1)

CPU = PlanOptions(device="cpu")

# tests/test_engine_xla.py's equivalence suite, built on either side.
SUITE = {
    "default": lambda m: m.default_instance(),
    "random-6-6-10": lambda m: m.random_instance(6, 6, 10, seed=1),
    "random-8-5-6": lambda m: m.random_instance(8, 5, 6, seed=2),
    "random-10-10-10": lambda m: m.random_instance(10, 10, 10, seed=3),
    "stressed-1.15": lambda m: m.default_instance().stressed(1.15),
    "stressed-1.3": lambda m: m.default_instance().stressed(1.3),
    "tight-budget": lambda m: m.random_instance(6, 6, 10, seed=4,
                                                budget=40.0),
}
# The work counters of one solve (timings and the gate's bypass count
# follow the wall clock and are left out).
WORK_COUNTERS = ("device_calls_phase2", "device_calls_screen",
                 "screen_sources", "screened_clean", "moves_applied",
                 "rescans", "scans", "orderings_evaluated", "restarts",
                 "early_stopped", "winning_order")


def _tol(obj):
    return 1e-6 * max(1.0, abs(obj))


def _assert_feasible_scalar(inst, sol, label):
    """Feasibility via the frozen per-constraint walk, not the engine's
    own state."""
    viol = feasibility(inst, sol, enforce_zeta=False)
    bad = {k: v for k, v in viol.items() if v > 1e-4}
    assert not bad, f"{label}: constraint violations {bad}"


def _agh_cpu(inst, **kw):
    return agh_torch(inst, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_tier():
    """The reference's jitted tier (needs jax)."""
    pytest.importorskip("jax")
    from repro.core.xla import engine
    return engine


# ---------------------------------------------------------------------------
# Mirror of tests/test_engine_xla.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SUITE))
def test_torch_objective_dominates_numpy(name):
    inst = SUITE[name](core)
    sol_np = agh(inst, seed=0)
    sol_t = _agh_cpu(inst, seed=0)
    o_np, o_t = objective(inst, sol_np), objective(inst, sol_t)
    assert o_t <= o_np + _tol(o_np), (name, o_t, o_np)
    assert is_feasible(inst, sol_t, enforce_zeta=False)
    _assert_feasible_scalar(inst, sol_t, name)
    assert sol_t.method == "AGH-TORCH"


def test_torch_stats_counters():
    inst = random_instance(8, 5, 6, seed=2)
    stats = {}
    _agh_cpu(inst, stats=stats)
    assert stats["engine"] == "torch"
    assert isinstance(stats["early_stopped"], bool)
    assert stats["orderings_evaluated"] >= 6
    assert stats["device_calls_phase2"] > 0
    assert stats["screened_clean"] > 0
    assert stats["screened_clean"] <= stats["screen_sources"]


def test_torch_rejects_reference_local_search():
    with pytest.raises(ValueError, match="reference"):
        _agh_cpu(default_instance(), local_search="reference")


@pytest.mark.parametrize("engine", ["torch", "xla"])
def test_plan_facade_engine_kwarg(engine):
    inst = random_instance(6, 6, 10, seed=1)
    res_np = plan(instance=inst)
    res_t = plan(instance=inst, engine=engine, options=CPU)
    assert res_t.options["engine"] == engine
    assert res_t.options["device"] == "cpu"
    assert res_t.diagnostics["engine"] == "torch"
    assert res_t.objective <= res_np.objective + _tol(res_np.objective)
    assert res_t.feasible
    with pytest.raises(ValueError, match="not both"):
        from repro_torch.planner import PlanRequest
        plan(PlanRequest(instance=inst), engine=engine)


def test_plan_unknown_engine_rejected():
    with pytest.raises(ValueError, match="unknown engine"):
        plan(instance=default_instance(), options=PlanOptions(engine="tpu"))


def test_session_warm_replan_torch():
    """Warm replans ride the same tier: the incumbent seeds the torch
    multi-start and the drifted solve stays feasible and competitive
    with a cold numpy solve of the drifted instance."""
    inst = random_instance(6, 6, 10, seed=1)
    ses = PlanSession(engine="torch", options=CPU)
    ses.plan(instance=inst)
    assert ses.options.engine == "torch" and ses.options.device == "cpu"
    drift = inst.with_lam(inst.lam * 1.12)
    res = ses.replan(instance=drift)
    assert ses.warm_replans == 1
    assert res.diagnostics["engine"] == "torch"
    assert res.diagnostics.get("warm_started") is True
    assert res.feasible
    cold = plan(instance=drift)
    assert res.objective <= cold.objective * 1.05 + 1e-9
    _assert_feasible_scalar(drift, res.solution, "warm-replan")


def test_session_warm_replan_matches_reference(ref_tier):
    """`test_session_warm_replan_xla` on both sides: the port's torch
    session and the reference's xla session give the same plans."""
    from repro.planner import PlanSession as RefSession
    got, want = [], []
    for ses, m, out in ((PlanSession(engine="torch", options=CPU),
                         core, got),
                        (RefSession(engine="xla"), ref_core, want)):
        inst = m.random_instance(6, 6, 10, seed=1)
        out.append(ses.plan(instance=inst))
        out.append(ses.replan(instance=inst.with_lam(inst.lam * 1.12)))
    for g, w in zip(got, want, strict=True):
        assert g.objective == pytest.approx(w.objective, rel=1e-9, abs=0)
        np.testing.assert_array_equal(g.solution.q, w.solution.q)
        np.testing.assert_array_equal(g.solution.w, w.solution.w)
        assert g.diagnostics["warm_started"] == w.diagnostics["warm_started"]


def test_warm_start_dominates_incumbent():
    inst = random_instance(8, 5, 6, seed=2)
    s1 = _agh_cpu(inst, seed=0)
    drift = inst.with_lam(inst.lam * 1.1)
    stats = {}
    s2 = _agh_cpu(drift, warm_start=s1, stats=stats)
    assert stats["warm_started"] is True
    assert "warm_objective" in stats
    assert objective(drift, s2) <= stats["warm_objective"] + 1e-9
    assert is_feasible(drift, s2, enforce_zeta=False)


def test_batch_width_invariance():
    """Infinite patience: the lane chunking changes nothing. Finite
    patience: every width still dominates the numpy sequential driver."""
    inst = random_instance(8, 5, 6, seed=2)
    base = _agh_cpu(inst, seed=0, patience=10**9)
    for bw in (1, 3):
        sol = _agh_cpu(inst, seed=0, patience=10**9, batch_width=bw)
        assert abs(objective(inst, sol) - objective(inst, base)) <= 1e-9
        assert np.array_equal(sol.q, base.q)
        assert np.array_equal(sol.w, base.w)
    o_np = objective(inst, agh(inst, seed=0, workers=0))
    for bw in (1, 4):
        o_bw = objective(inst, _agh_cpu(inst, seed=0, batch_width=bw))
        assert o_bw <= o_np + _tol(o_np)


def test_numpy_default_untouched():
    inst = random_instance(6, 6, 10, seed=1)
    res = plan(instance=inst)
    assert res.options["engine"] == "numpy"
    assert "device" not in res.options
    assert abs(res.objective - objective(inst, agh(inst))) <= 1e-9


try:
    from hypothesis import given, settings, strategies as st
    _HAS_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised on minimal hosts
    _HAS_HYPOTHESIS = False


if _HAS_HYPOTHESIS:
    @settings(max_examples=10, deadline=None)
    @given(st.integers(3, 8), st.integers(3, 6), st.integers(4, 10),
           st.integers(0, 10_000))
    def test_torch_dominance_property(I, J, K, seed):
        inst = random_instance(I, J, K, seed=seed)
        o_np = objective(inst, agh(inst, seed=0))
        sol_t = _agh_cpu(inst, seed=0)
        assert objective(inst, sol_t) <= o_np + _tol(o_np)
        assert is_feasible(inst, sol_t, enforce_zeta=False)
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_torch_dominance_property():
        pass


# ---------------------------------------------------------------------------
# The two programs: keys and verdicts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["default", "random-8-5-6",
                                  "random-10-10-10", "stressed-1.3"])
def test_phase2_keys_are_rank_keys_all_bitwise(name, monkeypatch):
    """Every lane step's device keys equal numpy's `rank_keys_all` on the
    lane's own state, bit for bit (inf positions included)."""
    inst = SUITE[name](core)
    preps, checked = [], []
    prep, walk = tier_engine._phase2_prep, tier_engine._phase2_walk

    def recording_prep(st, i, active, jj, kk):
        c_arr, d_sel = prep(st, i, active, jj, kk)
        preps.append((c_arr.copy(), d_sel.copy()))
        return c_arr, d_sel

    def checking_walk(st, i, c_arr, kap0, kap1, active, jj, kk):
        c, d = preps.pop(0)
        pi, kappa, valid = rank_keys_all(st, i, c, d_sel=d)
        np.testing.assert_array_equal(
            kap0, np.where(valid & (pi == 0), kappa, np.inf).ravel())
        np.testing.assert_array_equal(
            kap1, np.where(valid & (pi == 1), kappa, np.inf).ravel())
        checked.append(i)
        return walk(st, i, c_arr, kap0, kap1, active, jj, kk)

    monkeypatch.setattr(tier_engine, "_phase2_prep", recording_prep)
    monkeypatch.setattr(tier_engine, "_phase2_walk", checking_walk)
    _agh_cpu(inst, batch_width=3)
    assert len(checked) >= inst.I * 8 and not preps


def _deep_copy(obj):
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_deep_copy(o) for o in obj)
    return obj


@pytest.fixture(scope="module", params=["random-8-5-6", "default"])
def recorded_calls(request, ref_tier):
    """Every call of the reference solve to its two jitted programs: the
    padded-call inputs (copied: the engine reuses its buffers) and the
    outputs (copied before `_phase2_walk` masks them)."""
    from repro.core.xla import kernels as ref_kernels
    calls = {"phase2": [], "screen": []}
    p2, sc = ref_kernels.phase2_keys, ref_kernels.screen_sources

    def rec_p2(tx, items, counters=None):
        items = _deep_copy(items)
        out = p2(tx, items, counters)
        calls["phase2"].append((items, _deep_copy(out)))
        return out

    def rec_sc(tx, groups, srcs, load, counters=None):
        args = _deep_copy((groups, srcs, load))
        out = sc(tx, groups, srcs, load, counters)
        calls["screen"].append((args, out.copy()))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_tier.kernels, "phase2_keys", rec_p2)
    mp.setattr(ref_tier.kernels, "screen_sources", rec_sc)
    try:
        ref_tier.agh_xla(SUITE[request.param](ref_core))
    finally:
        mp.undo()
    assert calls["phase2"] and calls["screen"]
    return request.param, calls


def test_phase2_keys_match_reference_program(recorded_calls):
    """The reference's recorded phase-2 inputs through the port: same
    inf positions, values at rtol 1e-12. (Bitwise is not asked: XLA on the
    CPU fuses a multiply-add into an FMA, so its keys sit an ulp from
    numpy's `rank_keys_all`, which the port's keys equal bitwise.)"""
    name, calls = recorded_calls
    tx = tensors_for(SUITE[name](core),
                     torch.device("cpu"))
    for items, want in calls["phase2"]:
        got = tier_kernels.phase2_keys(tx, items)
        for g, w in zip(got, want, strict=True):
            assert g.shape == w.shape
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
            fin = np.isfinite(w)
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-12, atol=0)


def test_screen_verdicts_match_reference_program(recorded_calls):
    name, calls = recorded_calls
    tx = tensors_for(SUITE[name](core),
                     torch.device("cpu"))
    counters, n_src = {}, 0
    for (groups, srcs, load), want in calls["screen"]:
        got = tier_kernels.screen_sources(tx, groups, srcs, load, counters)
        np.testing.assert_array_equal(got, want)
        n_src += len(srcs)
    assert counters == {"device_calls_screen": len(calls["screen"]),
                        "screen_sources": n_src}


def test_scatter_pads_to_a_discarded_column():
    base = torch.arange(12, dtype=torch.float64).reshape(2, 6)
    cols = torch.tensor([[1, 6, 6], [0, 5, 6]])
    vals = torch.tensor([[-1.0, 7.0, 8.0], [-2.0, -3.0, 9.0]],
                        dtype=torch.float64)
    got = tier_kernels._scatter_cols(base, cols, vals)
    want = base.clone()
    want[0, 1], want[1, 0], want[1, 5] = -1.0, -2.0, -3.0
    assert torch.equal(got, want)


def test_bucket_ladders_are_the_reference_ones(ref_tier):
    from repro.core.xla import kernels as ref_kernels
    for name in ("_ACT_STEPS", "_SRC_STEPS", "_GRP_STEPS",
                 "_SCREEN_ACT_STEPS"):
        assert getattr(tier_kernels, name) == getattr(ref_kernels, name)
    assert (tier_engine._SCREEN_CHUNK, tier_engine._SCREEN_CHUNK_WIDE) == (
        ref_tier._SCREEN_CHUNK, ref_tier._SCREEN_CHUNK_WIDE)
    for n in (0, 1, 64, 65, 700, 5000):
        for steps in (tier_kernels._SRC_STEPS, tier_kernels._ACT_STEPS):
            assert (tier_kernels._bucket(n, steps, 4096)
                    == ref_kernels._bucket(n, steps, 4096))


# ---------------------------------------------------------------------------
# Against the reference tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SUITE))
def test_objective_equals_reference_tier_and_numpy(name, ref_tier):
    inst = SUITE[name](core)
    ref_inst = SUITE[name](ref_core)
    got = _agh_cpu(inst, seed=0)
    want = ref_tier.agh_xla(ref_inst, seed=0)
    o_got, o_want = objective(inst, got), ref_core.objective(ref_inst, want)
    o_np = objective(inst, agh(inst, seed=0))
    assert abs(o_got - o_want) <= 1e-9 * max(1.0, abs(o_want))
    assert abs(o_got - o_np) <= 1e-9 * max(1.0, abs(o_np))
    np.testing.assert_array_equal(got.q, want.q)
    np.testing.assert_array_equal(got.w, want.w)


def test_stats_equal_reference_tier(ref_tier):
    got, want = {}, {}
    _agh_cpu(random_instance(8, 5, 6, seed=2), stats=got)
    ref_tier.agh_xla(ref_core.random_instance(8, 5, 6, seed=2), stats=want)
    assert (got["engine"], want["engine"]) == ("torch", "xla")
    for key in WORK_COUNTERS:
        assert got.get(key) == want.get(key), key
    assert set(got) == set(want)


# ---------------------------------------------------------------------------
# Devices and the GPU-cap fallback
# ---------------------------------------------------------------------------

def test_torch_engine_raises_without_cuda():
    """No device means CUDA; where it is absent the tier raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inst = random_instance(6, 6, 10, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        agh_torch(inst)
    for engine in ("torch", "xla"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            plan(instance=inst, engine=engine)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PlanSession(engine=engine).plan(instance=inst)
    assert issubclass(EngineUnavailableError, RuntimeError)


def test_avail_caps_fall_back_to_numpy(ref_tier):
    inst = random_instance(8, 8, 6, seed=1)
    caps = np.maximum(np.ceil(agh(inst).y.sum(axis=0) * 0.6), 1.0)
    capped = dataclasses.replace(inst, avail_gpus=caps)
    stats = {}
    got = _agh_cpu(capped, stats=stats)
    assert stats["xla_avail_fallback"] is True
    assert "engine" not in stats          # the numpy engine reported
    direct = agh(capped)
    for f in ("x", "y", "q", "w", "z", "u"):
        np.testing.assert_array_equal(getattr(got, f), getattr(direct, f))
    ref_stats = {}
    ref_inst = ref_core.random_instance(8, 8, 6, seed=1)
    want = ref_tier.agh_xla(
        dataclasses.replace(ref_inst, avail_gpus=caps), stats=ref_stats)
    assert ref_stats == stats
    np.testing.assert_array_equal(got.x, want.x)
    assert capped._xla_tensors is None     # nothing was uploaded


def test_tensor_bundle_is_cached_per_device():
    inst = random_instance(6, 6, 10, seed=1)
    cpu = torch.device("cpu")
    tx = tensors_for(inst, cpu)
    assert tensors_for(inst, cpu) is tx
    assert set(inst._xla_tensors) == {"cpu"}
    assert tx.m1_delay.dtype == torch.float64
    assert tx.m1_valid.dtype == torch.bool
    assert tx.m1_delay.shape == (inst.I, inst.J * inst.K)
    assert inst.with_lam(inst.lam * 1.1)._xla_tensors is None
