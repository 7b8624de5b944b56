"""Planner -> serving bridge: the paper's allocator as a first-class framework
feature.

Three pieces:
  1. A TPU tier catalog (slice classes × serving dtype) mirroring the
     paper's GPU tiers, so the SAME planner (GH/AGH/MILP) provisions TPU
     fleets. Precision tiers map to weight dtypes (bf16 / int8 / int4
     weight-only) with the paper's nu/mu multipliers.
  2. Roofline-calibrated delay coefficients: the planner's analytical
     d_comp per (model, tier) is re-fit from the compiled dry-run's
     per-device HBM bytes (decode is bandwidth-bound — eq. d_comp =
     bytes_per_token / BW), replacing NVIDIA-datasheet constants with
     numbers derived from the ACTUAL compiled program.
  3. `DeploymentSpec`: maps each active (model, tier) pair's (TP, PP)
     decision onto a concrete device mesh (TP -> 'model' axis, PP -> 'stage'
     axis) plus routing fractions for the serving router.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from .instance import MU, NU, Instance
from .solution import Solution

# TPU tier catalog: (chip class, serving dtype). Hourly prices follow
# public on-demand per-chip pricing ratios; v5e is the production target.
TPU_TIERS = [
    # name,        mem GB, TFLOP/s(bf16), $/h,  BW GB/s, precision
    ("v5e-bf16",   16.0,   197.0,         1.20, 819.0,  "FP16"),
    ("v5e-int8",   16.0,   394.0,         1.20, 819.0,  "INT8"),
    ("v5p-bf16",   95.0,   459.0,         4.20, 2765.0, "FP16"),
    ("v5p-int8",   95.0,   918.0,         4.20, 2765.0, "INT8"),
    ("v4-bf16",    32.0,   275.0,         3.22, 1228.0, "FP16"),
    ("v4-int8",    32.0,   550.0,         3.22, 1228.0, "INT8"),
]


def tpu_instance(base: Instance) -> Instance:
    """The paper's instance with the GPU tier table swapped for TPU tiers.
    TP degrees extend to 16 (one 4x4 ICI ring) — the `model` mesh axis."""
    names, C, Pg, pc, BW, nu, mu = [], [], [], [], [], [], []
    for name, mem, tf, price, bw, prec in TPU_TIERS:
        names.append(name)
        C.append(mem)
        Pg.append(tf)
        pc.append(price)
        BW.append(bw)
        nu.append(NU[prec])
        mu.append(MU[prec])
    inst = dataclasses.replace(
        base, tier_names=names, C_gpu=np.array(C), P_gpu=np.array(Pg),
        p_c=np.array(pc), BW=np.array(BW), nu=np.array(nu), mu=np.array(mu),
        tp_degrees=[1, 2, 4, 8, 16])
    inst.__post_init__()
    return inst


def calibrate_from_dryrun(inst: Instance, dryrun_json: str,
                          arch_to_model: dict[str, int]) -> Instance:
    """Re-fit d_comp from compiled decode dry-runs: per-token HBM bytes per
    device / BW — the planner's bandwidth-bound decode roofline, measured on
    the actual compiled program instead of a datasheet."""
    with open(dryrun_json) as f:
        rows = json.load(f)
    scale = {}
    for r in rows:
        if (r.get("status") == "ok" and r.get("shape") == "decode_32k"
                and not r.get("multi_pod") and r["arch"] in arch_to_model):
            j = arch_to_model[r["arch"]]
            bytes_per_tok_dev = r["hlo_bytes_per_device"] / r["n_devices"]
            # analytical weight-stream bytes per device at this sharding
            analytic = 2.0 * r["params_active"] / r["n_devices"]
            scale[j] = max(0.25, min(4.0, bytes_per_tok_dev / max(analytic, 1)))
    if not scale:
        return inst
    inst = dataclasses.replace(inst)
    tau_scale = np.ones(inst.J)
    for j, s in scale.items():
        tau_scale[j] = s
    # d_comp = tau_i * B_j * nu_k / BW_k  -> fold the compiled-bytes ratio
    # into an effective per-model multiplier on B_j.
    inst.B = inst.B * tau_scale
    inst.__post_init__()
    return inst


@dataclasses.dataclass
class PairDeployment:
    model: str
    tier: str
    tp: int
    pp: int
    n_chips: int
    routing: dict[str, float]      # query type -> fraction of that type


@dataclasses.dataclass
class DeploymentSpec:
    pairs: list[PairDeployment]

    def mesh_shape_for(self, pair: PairDeployment):
        """(stage, model) mesh axes for one pair's serving engine."""
        return dict(shape=(pair.pp, pair.tp), axes=("stage", "model"))


def to_deployment(inst: Instance, sol: Solution) -> DeploymentSpec:
    pairs = []
    for j in range(inst.J):
        for k in range(inst.K):
            if sol.q[j, k] < 0.5:
                continue
            cfg = sol.config_of(inst, j, k)
            if cfg is None:
                continue
            n, m = cfg
            routing = {inst.query_names[i]: float(sol.x[i, j, k])
                       for i in range(inst.I) if sol.x[i, j, k] > 1e-9}
            pairs.append(PairDeployment(
                model=inst.model_names[j], tier=inst.tier_names[k],
                tp=n, pp=m, n_chips=int(sol.y[j, k]), routing=routing))
    return DeploymentSpec(pairs=pairs)
