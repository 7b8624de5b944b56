"""The allocator tier's two device programs, with host-side padding.

Two programs cover the engine's hot numeric loops:

* `phase2_keys` — the batched M2 ranking keys of GH Phase 2 for every
  multi-start lane at once (`rank_keys_all` over a lane axis): one call
  per lockstep step computes the (pi, kappa) argmin-walk inputs of all
  orderings, each lane at its own current type.  Active cells arrive as
  host-computed override values (exact numpy arithmetic) scattered over
  the resident M1 grids.

* `screen_sources` — the relocate screen: for a stacked batch of
  (lane, source-cell) rows, reproduce `score_moves_batch`'s improvement
  filter and cap-upper-bound prefilter against each lane's sweep-start
  state and reduce to one boolean per source ("could any destination
  improve?").  Sources that fail are provably non-improving (the caller
  adds slack to the thresholds so rounding can never flip a verdict from
  pass to fail); sources that pass get the exact numpy scan.

Both are eager torch in float64, one op at a time (no contraction across
ops), so on the CPU and on the card the keys are numpy's `rank_keys_all`
arithmetic bit for bit.  Shapes are padded to the same small set of
bucket sizes as the reference's jitted programs, so the padded shapes and
the call/source counters match it: scatter indices are padded with the
one-past-the-end column trick (a dummy column is appended, written, then
sliced off), and padded sources carry ``bound = -inf`` so they can never
report alive.  Each call uploads its padded host arrays once and copies
its result back once.
"""
from __future__ import annotations

import numpy as np
import torch

from .tier_tensors import TierInstanceTensors


def _bucket(n: int, steps: tuple[int, ...], cap: int) -> int:
    """Smallest padded size >= n from `steps` (clamped to `cap`)."""
    for s in steps:
        s = min(s, cap)
        if n <= s:
            return s
    return cap


def _pad2(rows: list[np.ndarray], n_rows: int, n_cols: int, fill,
          dtype) -> np.ndarray:
    out = np.full((n_rows, n_cols), fill, dtype=dtype)
    for r, a in enumerate(rows):
        out[r, : a.shape[0]] = a
    return out


def _scatter_cols(base: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``base`` with ``base[r, cols[r, a]] = vals[r, a]``; a column index
    equal to ``base.shape[1]`` (the padding) lands in a dummy column that
    is sliced off, the only place duplicate indices occur."""
    R, JK = base.shape
    p = torch.cat([base, base.new_zeros((R, 1))], dim=1)
    rows = torch.arange(R, dtype=torch.int64,
                        device=base.device)[:, None].expand_as(cols)
    p.index_put_((rows, cols), vals.to(base.dtype), accumulate=False)
    return p[:, :JK]


# ---------------------------------------------------------------------------
# Phase-2 ranking keys (rank_keys_all over a lane axis)
# ---------------------------------------------------------------------------

def _phase2_keys(m1_nm, psb_data, rho_d, m1_delay, m1_valid, ebf,
                 pc_flat, eps, Delta, Delta_T, i_idx, y, rr, E, D,
                 act_jk, act_cost, act_d, act_valid):
    # Cost/delay/validity grids: M1 rows gathered at each lane's current
    # type, the lane's active cells overridden with the host's exact
    # per-cell values (post-M3 configs, pair-config delays).
    inc = torch.clamp_min(m1_nm[i_idx] - y, 0.0)
    cost = (Delta_T * (pc_flat[None, :] * inc + psb_data[i_idx])
            + rho_d[i_idx])
    d = _scatter_cols(m1_delay[i_idx], act_jk, act_d)
    valid = _scatter_cols(m1_valid[i_idx], act_jk, act_valid)
    cost = _scatter_cols(cost, act_jk, act_cost)
    # x-bar = min(r_rem, error headroom, delay headroom); keys as in
    # rank_keys_all: pi=0 iff the pair absorbs the full residual.
    err_cap = (eps[i_idx] - E)[:, None] / ebf[i_idx]
    del_cap = (Delta[i_idx] - D)[:, None] / torch.clamp_min(d, 1e-12)
    xbar = torch.minimum(torch.minimum(rr[:, None], err_cap), del_cap)
    live = xbar > 1e-9
    valid = valid & live
    pi = xbar < rr[:, None] - 1e-9
    kappa = torch.where(live, cost / torch.where(live, xbar, 1.0),
                        torch.inf)
    kap0 = torch.where(valid & ~pi, kappa, torch.inf)
    kap1 = torch.where(valid & pi, kappa, torch.inf)
    return kap0, kap1


_ACT_STEPS = (64, 512, 4096)


def phase2_keys(tx: TierInstanceTensors, items: list[tuple],
                counters: dict | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Ranking keys for one lockstep step over a chunk of lanes.

    ``items`` holds one tuple per lane:
    ``(i, y_flat, rr, E, D, act_jk, act_cost, act_d, act_valid)`` —
    the lane's current type, its flat GPU-count grid, the type-local
    scalars, and the active-cell override vectors.  Returns writable
    numpy ``(kap0, kap1)`` of shape [len(items), J*K] ready for
    `_phase2_walk`'s destructive visited-masking.
    """
    JK = tx.JK
    R = len(items)
    a_max = max((it[5].shape[0] for it in items), default=0)
    A = _bucket(max(a_max, 1), _ACT_STEPS, JK)
    i_idx = np.fromiter((it[0] for it in items), np.int64, R)
    y = np.stack([it[1] for it in items])
    rr = np.fromiter((it[2] for it in items), np.float64, R)
    E = np.fromiter((it[3] for it in items), np.float64, R)
    D = np.fromiter((it[4] for it in items), np.float64, R)
    act_jk = _pad2([it[5] for it in items], R, A, JK, np.int64)
    act_cost = _pad2([it[6] for it in items], R, A, 0.0, np.float64)
    act_d = _pad2([it[7] for it in items], R, A, 0.0, np.float64)
    act_valid = _pad2([it[8] for it in items], R, A, False, bool)
    dev = tx.device
    up = lambda a: torch.as_tensor(a, device=dev)
    kap0, kap1 = _phase2_keys(
        tx.m1_nm, tx.psb_data, tx.rho_d, tx.m1_delay, tx.m1_valid, tx.ebf,
        tx.pc_flat, tx.eps, tx.Delta, tx.Delta_T, up(i_idx),
        up(y), up(rr), up(E), up(D),
        up(act_jk), up(act_cost), up(act_d), up(act_valid))
    out = torch.stack([kap0, kap1]).cpu().numpy()
    if counters is not None:
        counters["device_calls_phase2"] = \
            counters.get("device_calls_phase2", 0) + 1
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Relocate screen (score_moves_batch's filters, any-destination reduce)
# ---------------------------------------------------------------------------

def _screen(m1_delay, m1_valid, m1_rental, m1_nm, ebf, lpx, psB_flat,
            comp_flat, Delta_T, g_i, g_lane, z_lt, act_jk, act_nm,
            act_d, act_ok, load, s_g, s_jk, dyn, bound, rr2, err_num,
            del_num, fthr):
    S = s_g.shape[0]
    # Destination rows per (lane, type) group — the DestCache row
    # construction: M1 grids with each lane's active cells overridden
    # (pair config delay/validity, zero incremental rental, pair GPU
    # count), plus the type's admission-dependent static cost.
    d_sel = _scatter_cols(m1_delay[g_i], act_jk, act_d)
    okr = _scatter_cols(m1_valid[g_i], act_jk, act_ok)
    rent = _scatter_cols(m1_rental[g_i], act_jk, torch.zeros_like(act_d))
    nmd = _scatter_cols(m1_nm[g_i], act_jk, act_nm)
    dcost = Delta_T * (rent + torch.where(z_lt, 0.0, psB_flat[None, :]))
    comp = comp_flat[None, :] * nmd - load[g_lane]
    # Per-source improvement filter + cap upper bound, reduced to one
    # "any destination alive" bit.
    ds = d_sel[s_g]
    delta = dcost[s_g] + dyn[:, None] * ds
    cand = okr[s_g] & (delta < bound[:, None])
    cand = _scatter_cols(cand, s_jk[:, None],
                         torch.zeros((S, 1), dtype=torch.bool,
                                     device=cand.device))
    si = g_i[s_g]
    ub = torch.minimum(rr2[:, None], err_num[:, None] / ebf[si])
    ub = torch.minimum(ub, del_num[:, None] / torch.clamp_min(ds, 1e-12))
    lpx_s = lpx[si]
    gcap = comp[s_g] / torch.where(lpx_s > 1e-18, lpx_s, 1.0)
    ub = torch.where(lpx_s > 1e-18, torch.minimum(ub, gcap), ub)
    alive = cand & (ub >= fthr[:, None])
    return torch.any(alive, dim=1)


# Geometric bucket ladders (the reference's): steps double, so the set of
# padded shapes stays O(log) while padding waste is bounded at 2x.
_SRC_STEPS = (128, 256, 512, 1024, 2048, 4096)
_GRP_STEPS = (64, 128, 256, 512, 1024, 2048, 4096)
_SCREEN_ACT_STEPS = (128, 512, 2048, 8192)


def screen_sources(tx: TierInstanceTensors, groups: list[tuple],
                   srcs: list[tuple], load: np.ndarray,
                   counters: dict | None = None) -> np.ndarray:
    """One padded screen call; see the module docstring.

    ``groups[g] = (lane_idx, type, z_lt_flat, act_jk, act_nm, act_d,
    act_ok)`` — one row per (lane, type) with the lane's active-cell
    overrides; ``srcs[s] = (g, s_jk, dyn, bound, rr2, err_num, del_num,
    fthr)``; ``load`` is the [n_lanes, J*K] stacked per-lane compute
    load (padded to the solve's full lane count so the shape is
    per-solve constant).  Returns a bool verdict per real source
    (True = may improve, run the exact scan).
    """
    JK = tx.JK
    nG, nS = len(groups), len(srcs)
    a_max = max((g[3].shape[0] for g in groups), default=0)
    A = _bucket(max(a_max, 1), _SCREEN_ACT_STEPS, JK)
    G = _bucket(nG, _GRP_STEPS, max(nG, 1))
    S = _bucket(nS, _SRC_STEPS, max(nS, 1))
    g_i = np.zeros(G, np.int64)
    g_lane = np.zeros(G, np.int64)
    z_lt = np.zeros((G, JK), bool)
    act_jk = np.full((G, A), JK, np.int64)
    act_nm = np.zeros((G, A), np.float64)
    act_d = np.zeros((G, A), np.float64)
    act_ok = np.zeros((G, A), bool)
    for g, (lane, ty, z_row, a_jk, a_nm, a_d, a_ok) in enumerate(groups):
        g_i[g] = ty
        g_lane[g] = lane
        z_lt[g] = z_row
        n = a_jk.shape[0]
        act_jk[g, :n] = a_jk
        act_nm[g, :n] = a_nm
        act_d[g, :n] = a_d
        act_ok[g, :n] = a_ok
    s_g = np.zeros(S, np.int64)
    s_jk = np.full(S, JK, np.int64)
    dyn = np.zeros(S, np.float64)
    bound = np.full(S, -np.inf)
    rr2 = np.zeros(S, np.float64)
    err_num = np.zeros(S, np.float64)
    del_num = np.zeros(S, np.float64)
    fthr = np.zeros(S, np.float64)
    for s, (g, jk, dy, bd, r2, en, dn, ft) in enumerate(srcs):
        s_g[s], s_jk[s] = g, jk
        dyn[s], bound[s], rr2[s] = dy, bd, r2
        err_num[s], del_num[s], fthr[s] = en, dn, ft
    dev = tx.device
    up = lambda a: torch.as_tensor(a, device=dev)
    alive = _screen(tx.m1_delay, tx.m1_valid, tx.m1_rental, tx.m1_nm,
                    tx.ebf, tx.lpx, tx.psB_flat, tx.comp_flat, tx.Delta_T,
                    up(g_i), up(g_lane), up(z_lt), up(act_jk), up(act_nm),
                    up(act_d), up(act_ok), up(load), up(s_g), up(s_jk),
                    up(dyn), up(bound), up(rr2), up(err_num), up(del_num),
                    up(fthr))
    if counters is not None:
        counters["device_calls_screen"] = \
            counters.get("device_calls_screen", 0) + 1
        counters["screen_sources"] = \
            counters.get("screen_sources", 0) + nS
    return alive[:nS].cpu().numpy()
