"""The port's risk subsystem (`repro_torch.risk`) on the CPU, against its own
exact oracle and against the reference's `repro.risk`.

Mirrors tests/test_risk.py with `device="cpu"`: the pdhg engine reproduces
the exact HiGHS oracle per scenario at rtol 1e-5 — nominal, stressed with
wide bases (the 24-row Woodbury shape class) and forced through restarted
PDHG — with every scenario counted in exactly one diagnostics bucket. Held
against the reference module itself: the exact engine is bitwise the
reference's (same scipy, same inputs); the pdhg engine's costs are within
rtol 1e-5 of the reference's with equal diagnostics; `_candidate_kernel`,
`_pdhg_setup` and `_pdhg_block`, fed the same numpy inputs and the same
anchor pack, agree with the jax programs at rtol 1e-9 / atol 1e-12 with
equal `ok` flags, NaN and inf included. Restarted PDHG adapts its primal
weight from ratios of iterate differences, so two implementations whose
blocks agree to ~1e-15 still part after a few hundred iterations (the
reference does so against itself under a 4e-16 nudge of its start); the
forced-PDHG path is therefore held to the oracle, not to the reference's
iteration counts.

The reference's solver turns on `jax_enable_x64` for the whole process
when imported, so it is imported inside a fixture and every array crosses
over with an explicit dtype.
"""
import numpy as np
import pytest
import torch

import _ref_cpu  # noqa: F401  (pins the reference to the CPU)

from repro import core as ref_core
from repro_torch import core
from repro_torch.core import agh, gh, random_instance
from repro_torch.core.stage2 import Stage2System
from repro_torch.risk import RiskReport, rank_deployments, risk_evaluate
from repro_torch.risk import solver as T
from repro_torch.risk.api import PROTOCOL
from repro_torch.risk.metrics import var_cvar
from repro_torch.risk.solver_exact import ExactChunkSolver

torch.set_num_threads(1)

RTOL = 1e-5                     # the pdhg-vs-oracle acceptance contract
KERNEL_RTOL, KERNEL_ATOL = 1e-9, 1e-12   # one device program vs the jax one


@pytest.fixture(scope="module")
def R():
    """The reference's solver module (imports jax, switches it to x64)."""
    pytest.importorskip("jax")
    from repro.risk import solver
    return solver


@pytest.fixture(scope="module")
def inst():
    return random_instance(10, 8, 8, seed=7)


@pytest.fixture(scope="module")
def deploy(inst):
    return gh(inst)


def _batch(inst, S, seed=None):
    rng = np.random.default_rng(PROTOCOL["seed"] if seed is None else seed)
    return inst.perturbed_batch(rng, S, d_infl=PROTOCOL["d_infl"],
                                e_infl=PROTOCOL["e_infl"],
                                lam_pm=PROTOCOL["lam_pm"])


def _cases(m):
    """(instance, deployment, S, batch seed, solver kwargs) on both sides,
    built by the same constructors and seeds: nominal gh plan; agh plan at
    1.5x stress (15-16 active delay/error rows per basis); forced PDHG."""
    big = m.random_instance(20, 20, 20, seed=42)
    small = m.random_instance(10, 8, 8, seed=7)
    return {"nominal": (small, m.gh(small), 300, None, {}),
            "stressed": (big.stressed(1.5), m.agh(big), 160, None, {}),
            "forced": (small, m.gh(small), 120, 5, {"max_anchors": 0})}


def _accounted(d, S):
    return (d["n_anchor0"] + d["n_harvest_exact"] + d["n_pdhg"]
            + d["n_fallback_exact"]) == S


# -- pdhg engine vs the exact oracle ------------------------------------

@pytest.mark.parametrize("case", ["nominal", "stressed", "forced"])
def test_pdhg_matches_oracle_per_scenario(case):
    inst, dep, S, seed, kw = _cases(core)[case]
    batch = _batch(inst, S, seed)
    system = Stage2System(inst, dep)
    solver = T.BatchedStage2Solver(system, device="cpu", **kw)
    syncs, calls, blocks = (T._to_host.syncs, T._candidate_kernel.calls,
                            T._pdhg_block.calls)
    out = solver.solve_scenarios(batch)
    out_ex = ExactChunkSolver(system).solve_scenarios(batch)
    np.testing.assert_allclose(out.costs, out_ex.costs, rtol=RTOL)
    np.testing.assert_array_equal(out.viols, out_ex.viols)
    d = solver.diagnostics
    assert d["n_scenarios"] == S and _accounted(d, S)
    # One device-to-host copy per candidate call and per PDHG block.
    assert (T._to_host.syncs - syncs == T._candidate_kernel.calls - calls
            + T._pdhg_block.calls - blocks)
    if case == "stressed":
        assert len(solver.anchors) > 0 and d["n_anchor0"] > 0
        assert any(a.pack[11].shape[1] == 24 for a in solver.anchors)
    if case == "forced":
        assert d["n_pdhg"] > 0 and T._pdhg_block.calls > blocks


# -- held against the reference module ----------------------------------

def test_exact_engine_bitwise_equals_reference(R, inst, deploy):
    from repro.core.stage2 import Stage2System as RefSystem
    from repro.risk import risk_evaluate as ref_risk_evaluate
    from repro.risk.solver_exact import ExactChunkSolver as RefExact
    ref_inst = ref_core.random_instance(10, 8, 8, seed=7)
    ref_dep = ref_core.gh(ref_inst)
    got = ExactChunkSolver(Stage2System(inst, deploy)).solve_scenarios(
        _batch(inst, 48))
    want = RefExact(RefSystem(ref_inst, ref_dep)).solve_scenarios(
        _batch(ref_inst, 48))
    for f in ("costs", "viols", "unmet", "util"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    r = risk_evaluate(inst, deploy, S=48, engine="exact").to_dict()
    w = ref_risk_evaluate(ref_inst, ref_dep, S=48, engine="exact").to_dict()
    r.pop("wall_s"), w.pop("wall_s")
    assert r == w


@pytest.mark.parametrize("case", ["nominal", "stressed"])
def test_pdhg_engine_matches_reference(R, case):
    from repro.core.stage2 import Stage2System as RefSystem
    inst, dep, S, seed, kw = _cases(core)[case]
    r_inst, r_dep, *_ = _cases(ref_core)[case]
    got = T.BatchedStage2Solver(Stage2System(inst, dep), device="cpu", **kw)
    want = R.BatchedStage2Solver(RefSystem(r_inst, r_dep), **kw)
    out = got.solve_scenarios(_batch(inst, S, seed))
    ref = want.solve_scenarios(_batch(r_inst, S, seed))
    np.testing.assert_allclose(out.costs, ref.costs, rtol=RTOL)
    assert got.diagnostics == want.diagnostics
    assert [a.key for a in got.anchors] == [a.key for a in want.anchors]


def _pair(R, case, S):
    """Both solvers on one case, each with its harvested anchors, and the
    case's coefficient rows (numpy, shared by both sides)."""
    from repro.core.stage2 import Stage2System as RefSystem
    inst, dep, _, seed, _ = _cases(core)[case]
    r_inst, r_dep, *_ = _cases(ref_core)[case]
    got = T.BatchedStage2Solver(Stage2System(inst, dep), device="cpu")
    want = R.BatchedStage2Solver(RefSystem(r_inst, r_dep))
    batch = _batch(inst, S, seed)
    got.solve_scenarios(batch)
    want.solve_scenarios(_batch(r_inst, S, seed))
    vals, c = got.system.coefficient_batch(batch)
    return got, want, vals, c


def _assert_close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if want.dtype == bool:
        assert np.array_equal(got, want), what
    else:
        np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL, err_msg=what)


@pytest.mark.parametrize("case", ["nominal", "stressed"])
def test_candidate_kernel_matches_reference(R, case):
    """Every anchor's pack on every scenario: most lie outside that
    anchor's basis cell, so its proposal there is garbage that verification
    must reject in the same way; one row of NaN coefficients must fail
    verification with an inf score, not raise."""
    import jax.numpy as jnp
    got, want, vals, c = _pair(R, case, 96)
    vals = vals.copy()
    vals[7] = np.nan
    S = vals.shape[0]
    pad = np.concatenate([np.arange(S), np.zeros(T._bucket(S) - S, int)])
    names = ("ok", "p", "z", "y", "rowsv", "score")
    assert len(got.anchors) == len(want.anchors) > 0
    for ga, wa in zip(got.anchors, want.anchors, strict=True):
        for gp, wp in zip(ga.pack, wa.pack, strict=True):
            _assert_close(gp, wp, "pack")
        out_t = T._candidate_kernel(
            torch.from_numpy(vals), torch.from_numpy(c), torch.from_numpy(pad),
            got._d_rhs0, got._d_is_eq, got._d_rows, got._d_cols, got._d_ub,
            got._d_Rm, got._d_Rn, *ga.pack)
        out_r = R._candidate_kernel(
            jnp.asarray(vals, dtype=jnp.float64),
            jnp.asarray(c, dtype=jnp.float64),
            jnp.asarray(pad, dtype=jnp.int64), want._d_rhs0, want._d_is_eq,
            want._d_rows, want._d_cols, want._d_ub, want._d_Rm, want._d_Rn,
            *wa.pack)
        for n, a, b in zip(names, out_t, out_r, strict=True):
            _assert_close(a, b, n)
        assert not out_t[0][7] and out_t[5][7] == torch.inf


def test_pdhg_setup_and_block_match_reference(R):
    import jax.numpy as jnp
    got, want, vals, c = _pair(R, "nominal", 64)
    rng = np.random.default_rng(0)
    S = vals.shape[0]
    z0 = rng.uniform(0.0, 1.0, (S, got.n))
    y0 = rng.normal(size=(S, got.m))
    f64 = jnp.float64
    st_r = R._pdhg_setup(jnp.asarray(vals, dtype=f64),
                         jnp.asarray(c, dtype=f64), want._d_rhs0,
                         want._d_rows, want._d_cols, want._d_ub,
                         jnp.asarray(z0, dtype=f64), jnp.asarray(y0, dtype=f64))
    st_t = T._pdhg_setup(torch.from_numpy(vals), torch.from_numpy(c),
                         got._d_rhs0, got._d_rows, got._d_cols, got._d_ub,
                         torch.from_numpy(z0), torch.from_numpy(y0),
                         got._d_Rm, got._d_Rn)
    for a, b in zip(st_t, st_r, strict=True):
        _assert_close(a, b, "setup")
    vs, cs, rhss, ubs, sig0, tau0, omega, dr, dc, z, y = st_r
    # Two blocks, the second restarting from the first, both fed the
    # reference's state so that only one block's rounding is compared.
    z_r, y_r = z, y
    for _ in range(2):
        out_r = R._pdhg_block(vs, cs, rhss, ubs, sig0, tau0, want._d_is_eq,
                              want._d_rows, want._d_cols, want._d_Rm,
                              want._d_Rn, dr, omega, z, y, z_r, y_r,
                              jnp.asarray(50, dtype=jnp.int64))
        t = [torch.from_numpy(np.array(x)) for x in
             (vs, cs, rhss, ubs, sig0, tau0)]
        u = [torch.from_numpy(np.array(x)) for x in
             (dr, omega, z, y, z_r, y_r)]
        out_t = T._pdhg_block(*t, got._d_is_eq, got._d_rows, got._d_cols,
                              got._d_Rm, got._d_Rn, *u, 50)
        for n, a, b in zip(("z", "y", "omega", "p", "pf", "gap"), out_t,
                           out_r, strict=True):
            _assert_close(a, b, n)
        z, y, omega = out_r[:3]
        z_r, y_r = z, y


@pytest.mark.parametrize("Q", [8, 24])
def test_small_lu_solves_match_linalg_solve(Q):
    rng = np.random.default_rng(Q)
    M = rng.normal(size=(64, Q, Q)) + 2.0 * Q * np.eye(Q)
    r = rng.normal(size=(64, Q))
    Mt, rt = torch.from_numpy(M), torch.from_numpy(r)
    keep = Mt.clone()
    lu = T._lu_small(Mt)
    assert torch.equal(Mt, keep)            # the caller's tensor is intact
    h = T._solve_small(lu, rt)
    g = T._solve_small_t(lu, rt)
    assert torch.equal(rt, torch.from_numpy(r))
    want_h = torch.linalg.solve(Mt, rt)
    want_g = torch.linalg.solve(Mt.transpose(1, 2), rt)
    torch.testing.assert_close(h, want_h, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(g, want_g, rtol=1e-12, atol=1e-12)


def test_small_lu_zero_pivot_matches_reference(R):
    """A zero pivot gives inf/NaN exactly where jnp gives them."""
    import jax.numpy as jnp
    M = np.eye(4)[None].repeat(3, axis=0)
    M[1, 0, 0] = 0.0
    M[2, 2, 2] = 0.0
    M[2, 3, 2] = 1.0
    r = np.ones((3, 4))
    lu_t = T._lu_small(torch.from_numpy(M))
    lu_r = R._lu_small(jnp.asarray(M, dtype=jnp.float64))
    h_t, h_r = (T._solve_small(lu_t, torch.from_numpy(r)),
                R._solve_small(lu_r, jnp.asarray(r, dtype=jnp.float64)))
    g_t, g_r = (T._solve_small_t(lu_t, torch.from_numpy(r)),
                R._solve_small_t(lu_r, jnp.asarray(r, dtype=jnp.float64)))
    for a, b in ((lu_t, lu_r), (h_t, h_r), (g_t, g_r)):
        a, b = a.numpy(), np.asarray(b)
        assert not np.isfinite(b).all()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(a[np.isfinite(b)], b[np.isfinite(b)])


# -- no fallback --------------------------------------------------------

def test_pdhg_without_device_needs_cuda(inst, deploy):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        risk_evaluate(inst, deploy, S=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.BatchedStage2Solver(Stage2System(inst, deploy))


# -- metrics ------------------------------------------------------------

def test_cvar_hand_computed():
    """Rockafellar-Uryasev on costs 0..99 at alpha=0.9: VaR = 89.1, tail
    excess sum_{c=90..99}(c - 89.1) = 54 => CVaR = 89.1 + 0.54/0.1 = 94.5."""
    costs = np.arange(100, dtype=float)
    var, cvar = var_cvar(costs, 0.90)
    assert var == pytest.approx(89.1)
    assert cvar == pytest.approx(94.5)
    assert cvar >= var >= costs.mean()
    assert var_cvar(costs, 0.95)[1] >= cvar


# -- report / api -------------------------------------------------------

def test_risk_report_json_round_trip(inst, deploy):
    r = risk_evaluate(inst, deploy, S=64, device="cpu")
    r2 = RiskReport.from_json(r.to_json())
    assert r2.to_dict() == r.to_dict()
    s = r.summary()
    assert s["expected_cost"] == r.expected_cost
    assert s["cvar_0.95"] == r.cvar["0.95"]
    assert _accounted(r.diagnostics, 64)


@pytest.mark.parametrize("engine", ["exact", "pdhg"])
def test_risk_evaluate_chunking_invariant(inst, deploy, engine):
    r1 = risk_evaluate(inst, deploy, S=96, engine=engine, chunk=96,
                       device="cpu")
    r2 = risk_evaluate(inst, deploy, S=96, engine=engine, chunk=32,
                       device="cpu")
    for f in ("expected_cost", "cvar", "viol_quantiles"):
        a, b = getattr(r1, f), getattr(r2, f)
        if engine == "exact":
            assert a == b, f
        else:
            np.testing.assert_allclose(
                np.array(list(a.values()) if isinstance(a, dict) else a),
                np.array(list(b.values()) if isinstance(b, dict) else b),
                rtol=RTOL)


def test_risk_evaluate_rejects_unknown_engine(inst, deploy):
    with pytest.raises(ValueError, match="unknown engine"):
        risk_evaluate(inst, deploy, S=8, engine="simplex")


@pytest.mark.parametrize("engine", ["exact", "pdhg"])
def test_rank_deployments_equal_reference(R, engine):
    from repro.risk import rank_deployments as ref_rank
    inst = random_instance(10, 8, 8, seed=7)
    ref_inst = ref_core.random_instance(10, 8, 8, seed=7)
    rk = rank_deployments(inst, {"gh": gh(inst), "agh": agh(inst)}, S=48,
                          engine=engine, stress=1.5, device="cpu")
    want = ref_rank(ref_inst, {"gh": ref_core.gh(ref_inst),
                               "agh": ref_core.agh(ref_inst)},
                    S=48, engine=engine, stress=1.5)
    for k in ("ranking_expected", "ranking_cvar", "agree", "stress", "S"):
        assert rk[k] == want[k], k
    for name, rep in rk["reports"].items():
        ref = want["reports"][name]
        assert rep.expected_cost == pytest.approx(ref.expected_cost,
                                                  rel=RTOL)
        assert rep.diagnostics == ref.diagnostics
    e = [rk["reports"][k].expected_cost for k in rk["ranking_expected"]]
    assert e == sorted(e)
