"""The scans' backward on the CPU: the plain versions (`ssm_scan_bwd_ref`,
`rwkv6_wkv_bwd_ref`, the stepwise formulas) against torch autograd
through the forwards' plain versions, against `jax.vjp` of the JAX
package's kernel oracles, and, for the state and parameter gradients,
against `jax.vjp` of the JAX models' layers (their chunked `chunk_step`
scans); then torch twins of the CUDA kernels' chunked algebra (chunk
states from the forward, one sweep from the last chunk to the first that
carries the state gradient, dla summed term by term, WKV's sub-chunk
midpoint factoring) against autograd, and with the tensor cores' TF32
rounding emulated, where 3xTF32 holds the f32 bound and one TF32 product
does not.

Inputs come from numpy seeds. Tolerances are relative to the largest
entry of each gradient: 1e-5 for the plain versions (f32 sums of a few
hundred terms in another order), 2e-5 for the twins (the kernels' own
f32 bound), with a weak decay, a strong one (a chunk's cumulative log
decay far below -88) and a ragged T (no multiple of the 32-step chunk).
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py phase 12.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _grad
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
from repro_torch.kernels.rwkv6_wkv_bwd import kernel as wkv_bwd_kernel
from repro_torch.kernels.rwkv6_wkv_bwd.ops import rwkv6_wkv_bwd
from repro_torch.kernels.rwkv6_wkv_bwd.ref import rwkv6_wkv_bwd_ref
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan_bwd import kernel as ssm_bwd_kernel
from repro_torch.kernels.ssm_scan_bwd.ops import ssm_scan_bwd
from repro_torch.kernels.ssm_scan_bwd.ref import ssm_scan_bwd_ref

torch.set_num_threads(1)

SSM_NAMES = ("dx", "dBm", "dCm", "ddt", "dA", "dD", "dstate")
WKV_NAMES = ("dr", "dk", "dv", "dlw", "du", "dstate")


def _f32(rng, shape, scale=1.0) -> np.ndarray:
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _ssm_case(seed, B, T, nh, hp, N, decay="weak") -> dict:
    """The reference sweep's inputs (a weak decay: dt 0.001-0.1, A -0.5 to
    -2), or a strong one (dt 0.5-4, A -5 to -30), a nonzero initial
    state and the outputs' gradients, as numpy arrays."""
    rng = np.random.default_rng(seed)
    lo, hi, alo, ahi = ((0.001, 0.1, 0.5, 2.0) if decay == "weak"
                        else (0.5, 4.0, 5.0, 30.0))
    return dict(
        x=_f32(rng, (B, T, nh, hp)), Bm=_f32(rng, (B, T, N), 0.5),
        Cm=_f32(rng, (B, T, N), 0.5),
        dt=rng.uniform(lo, hi, (B, T, nh)).astype(np.float32),
        A=-rng.uniform(alo, ahi, (nh,)).astype(np.float32),
        D=_f32(rng, (nh,)), state=_f32(rng, (B, nh, hp, N)),
        dy=_f32(rng, (B, T, nh, hp)), dstate=_f32(rng, (B, nh, hp, N)))


def _wkv_case(seed, B, T, H, hd, decay_shift=-1.5) -> dict:
    """lw = -exp(N(0, 0.5) + decay_shift): -1.5 the kernel sweep's decay,
    -6 the models' own (w0 = -6: a weak decay, lw ~ -0.0025), 1.5 a
    strong one."""
    rng = np.random.default_rng(seed)
    r, k, v = (_f32(rng, (B, T, H, hd), 0.5) for _ in range(3))
    lw = -np.exp(_f32(rng, (B, T, H, hd), 0.5) + decay_shift)
    return dict(r=r, k=k, v=v, lw=lw.astype(np.float32),
                u=_f32(rng, (H, hd), 0.5), state=_f32(rng, (B, H, hd, hd)),
                dy=_f32(rng, (B, T, H, hd)), dstate=_f32(rng, (B, H, hd, hd)))


def _t(case: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in case.items()}


def _assert_rel(got, want, tol, names):
    for name, g, w in zip(names, got, want):
        g = torch.as_tensor(np.asarray(g, np.float32) if not isinstance(
            g, torch.Tensor) else g).float()
        w = torch.as_tensor(np.asarray(w, np.float32) if not isinstance(
            w, torch.Tensor) else w).float()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert torch.isfinite(g).all(), name
        rel = ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        assert rel <= tol, f"{name}: max error {rel:.3e} of max|want|"


def _autograd_ssm(c: dict, with_state: bool):
    ins = [c[k].clone().requires_grad_() for k in
           ("x", "Bm", "Cm", "dt", "A", "D", "state")]
    y, s = ssm_scan_ref(*ins[:6], ins[6] if with_state else None)
    loss = (y * c["dy"]).sum() + (with_state and (s * c["dstate"]).sum())
    grads = torch.autograd.grad(loss, ins[:6] + ([ins[6]] if with_state
                                                 else []))
    return grads


def _autograd_wkv(c: dict, with_state: bool):
    ins = [c[k].clone().requires_grad_() for k in
           ("r", "k", "v", "lw", "u", "state")]
    y, s = rwkv6_wkv_ref(*ins[:5], ins[5] if with_state else None)
    loss = (y * c["dy"]).sum() + (with_state and (s * c["dstate"]).sum())
    return torch.autograd.grad(loss, ins[:5] + ([ins[5]] if with_state
                                                else []))


# -------------------------------------- the plain backwards vs autograd

@pytest.mark.parametrize("T", [40, 77])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_bwd_ref_matches_autograd(T, with_state):
    c = _t(_ssm_case(T, 2, T, 3, 32, 16))
    got = ssm_scan_bwd_ref(c["x"], c["Bm"], c["Cm"], c["dt"], c["A"],
                           c["D"], c["state"] if with_state else None,
                           c["dy"], c["dstate"] if with_state else None)
    want = _autograd_ssm(c, with_state)
    _assert_rel(got[:len(want)], want, 1e-5, SSM_NAMES)
    assert got[6].dtype == torch.float32 and got[6].shape == c[
        "state"].shape


@pytest.mark.parametrize("T", [40, 77])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_bwd_ref_matches_autograd(T, with_state):
    c = _t(_wkv_case(T, 2, T, 2, 32))
    got = rwkv6_wkv_bwd_ref(c["r"], c["k"], c["v"], c["lw"], c["u"],
                            c["state"] if with_state else None, c["dy"],
                            c["dstate"] if with_state else None)
    want = _autograd_wkv(c, with_state)
    _assert_rel(got[:len(want)], want, 1e-5, WKV_NAMES)


def test_bwd_refs_take_no_output_gradient_as_zeros():
    """dy and dstate None mean zeros, and a zero gradient gives zeros."""
    c = _t(_ssm_case(1, 1, 20, 2, 32, 16))
    for g in ssm_scan_bwd_ref(c["x"], c["Bm"], c["Cm"], c["dt"], c["A"],
                              c["D"], c["state"], None, None):
        assert not g.any()
    w = _t(_wkv_case(1, 1, 20, 2, 32))
    for g in rwkv6_wkv_bwd_ref(w["r"], w["k"], w["v"], w["lw"], w["u"],
                               w["state"], None, None):
        assert not g.any()


def test_bwd_refs_return_the_inputs_dtypes():
    c = _t(_ssm_case(2, 1, 33, 2, 32, 16))
    x, Bm, Cm, dy = (c[k].to(torch.bfloat16) for k in ("x", "Bm", "Cm", "dy"))
    got = ssm_scan_bwd_ref(x, Bm, Cm, c["dt"], c["A"], c["D"], None, dy)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [
        torch.float32] * 4
    w = _t(_wkv_case(2, 1, 33, 2, 32))
    r, k, v, lw, dyw = (w[n].to(torch.bfloat16)
                        for n in ("r", "k", "v", "lw", "dy"))
    got = rwkv6_wkv_bwd_ref(r, k, v, lw, w["u"], None, dyw)
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [
        torch.float32] * 2


# ---------------------------------------------- against the JAX package

@pytest.mark.parametrize("T", [40, 64])
def test_ssm_bwd_ref_matches_jax_vjp(T):
    """jax.vjp of the reference's stepwise oracle (zero state, y only)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ref

    c = _ssm_case(T + 1, 2, T, 3, 32, 16)
    args = [jnp.asarray(c[k]) for k in ("x", "Bm", "Cm", "dt", "A", "D")]
    _, vjp = jax.vjp(jax_ref, *args)
    want = vjp(jnp.asarray(c["dy"]))
    t = _t(c)
    got = ssm_scan_bwd_ref(t["x"], t["Bm"], t["Cm"], t["dt"], t["A"],
                           t["D"], None, t["dy"])
    _assert_rel(got[:6], [np.asarray(w) for w in want], 1e-5, SSM_NAMES)


@pytest.mark.parametrize("T", [40, 64])
def test_wkv_bwd_ref_matches_jax_vjp(T):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref as jax_ref

    c = _wkv_case(T + 1, 2, T, 2, 32)
    args = [jnp.asarray(c[k]) for k in ("r", "k", "v", "lw", "u")]
    _, vjp = jax.vjp(jax_ref, *args)
    want = vjp(jnp.asarray(c["dy"]))
    t = _t(c)
    got = rwkv6_wkv_bwd_ref(t["r"], t["k"], t["v"], t["lw"], t["u"], None,
                            t["dy"])
    _assert_rel(got[:5], [np.asarray(w) for w in want], 1e-5, WKV_NAMES)


@pytest.mark.parametrize("kind", ["ssm_scan", "rwkv6_wkv"])
def test_scan_bwd_state_grads_match_reference_model(kind):
    """A JAX smoke layer run from a nonzero cache: jax.vjp of (out, the new
    scan state) through the reference's chunked `chunk_step` scan, for the
    gradient of the cached state and of the scan's parameters (A_log and
    D, or u). The port's plain backward gets the same scan inputs, built
    in JAX, and the dy that the layer's output gradient gives through the
    glue after the scan (torch autograd over the gating and group norm):
    1e-4 of max|want| (the layer's projections and the chunked form add
    f32 sums of a few hundred terms)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models import mamba2 as ref_mamba2
    from repro.models import rwkv6 as ref_rwkv6

    arch = "zamba2-7b" if kind == "ssm_scan" else "rwkv6-7b"
    cfg = ref_get_config(arch).smoke()
    rng = np.random.default_rng(9)
    B, T, d = 2, 64, cfg.d_model
    x = jnp.asarray(_f32(rng, (B, T, d)))
    d_out = _f32(rng, (B, T, d))
    if kind == "ssm_scan":
        p = ref_mamba2.mamba2_params(jax.random.PRNGKey(9), cfg)
        nh, hp, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        s0 = _f32(rng, (B, nh, hp, N))
        conv = jnp.zeros((B, cfg.conv_width - 1, cfg.di), jnp.float32)

        def layer(S, A_log, D):
            q = dict(p, A_log=A_log, D=D)
            out, cache = ref_mamba2.mamba2_apply(q, cfg, x,
                                                 dict(ssm=S, conv=conv))
            return out, cache["ssm"]

        primals = (jnp.asarray(s0), p["A_log"], p["D"])
        xin, _ = ref_mamba2._causal_conv(x @ p["wx"], p["conv"], conv)
        dt = jax.nn.softplus(x @ p["wdt"] + p["dt_bias"])
        A = -jnp.exp(p["A_log"])
        scan_in = [xin.reshape(B, T, nh, hp), x @ p["wB"], x @ p["wC"], dt,
                   A, p["D"]]
        z = torch.from_numpy(np.asarray(jax.nn.silu(x @ p["wz"])))
    else:
        p = ref_rwkv6.rwkv6_params(jax.random.PRNGKey(9), cfg)
        H, hd = d // 64, 64
        s0 = _f32(rng, (B, H, hd, hd))
        xprev = jnp.zeros((B, d), jnp.float32)

        def layer(S, u):
            q = dict(p, u=u)
            out, cache = ref_rwkv6.rwkv6_apply(q, cfg, x,
                                               dict(state=S, xprev=xprev))
            return out, cache["state"]

        primals = (jnp.asarray(s0), p["u"])
        xs = ref_rwkv6._shift(x, xprev)
        mix = [x * p["mu"][i] + xs * (1 - p["mu"][i]) for i in range(5)]
        r, k, v = ((mix[i] @ p[w]).reshape(B, T, H, hd)
                   for i, w in enumerate(("wr", "wk", "wv")))
        lw = -jnp.exp(p["w0"] + (mix[4] @ p["wA"]) @ p["wB"])
        scan_in = [r, k, v, lw.reshape(B, T, H, hd), p["u"]]
        g = torch.from_numpy(np.asarray(jax.nn.silu(mix[3] @ p["wg"])))
    (_, s_out), vjp = jax.vjp(layer, *primals)
    d_state = _f32(rng, s_out.shape)
    want = vjp((jnp.asarray(d_out), jnp.asarray(d_state)))

    ins = [torch.from_numpy(np.array(a, np.float32)) for a in scan_in]
    wo = torch.from_numpy(np.asarray(p["wo"]))
    S0, dS = torch.from_numpy(s0), torch.from_numpy(d_state)
    if kind == "ssm_scan":
        y = ssm_scan_ref(*ins, S0)[0].requires_grad_()
        out = (y.reshape(B, T, -1) * z) @ wo
        dy, = torch.autograd.grad(out, y, torch.from_numpy(d_out))
        got = ssm_scan_bwd_ref(*ins, S0, dy, dS)
        # d A_log = dA * dA/dA_log = dA * A.
        got = (got[6], got[4] * ins[4], got[5])
        names = ("dstate", "dA_log", "dD")
    else:
        y = rwkv6_wkv_ref(*ins, S0)[0].requires_grad_()
        yn = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
        out = (yn.reshape(B, T, d) * g) @ wo
        dy, = torch.autograd.grad(out, y, torch.from_numpy(d_out))
        got = rwkv6_wkv_bwd_ref(*ins, S0, dy, dS)
        got = (got[5], got[4])
        names = ("dstate", "du")
    _assert_rel(got, [np.asarray(w) for w in want], 1e-4, names)


# ------------------------------ the kernels' chunked algebra, on the CPU
#
# Torch twins of ssm_scan_bwd.cu and rwkv6_wkv_bwd.cu. The forward kernel's
# chunk states, then one sweep over the chunks from last to first that
# carries the state gradient G: each chunk's gradients come from the state
# it starts from (read from the chunk states) and G at its end, then G
# steps back over the chunk. In f32 with the kernels' sums: SSD exponents
# summed within the chunk, dla term by term, dD from the diagonal of
# dy x^T; WKV decays in base-2 logarithms, the 16-step sub-chunks'
# midpoint factoring with the two diagonal blocks apart, dlw a reverse sum
# of dC. Every product goes through `mm`, so a test can run it on emulated
# TF32 tensor cores.

Q = 32
SUB = 16
_LOG2E = 1.4426950408889634


def _excl(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Exclusive cumulative sum along `dim`, by a shift: no subtraction."""
    z = torch.zeros_like(a.narrow(dim, 0, 1))
    return torch.cumsum(torch.cat([z, a.narrow(dim, 0, a.shape[dim] - 1)],
                                  dim), dim)


def _rev(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum from the end along `dim`."""
    return torch.flip(torch.cumsum(torch.flip(a, [dim]), dim), [dim])


def _pad(a: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((a.shape[0], n - a.shape[1])
                                     + a.shape[2:])], 1)


def _tf32(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """x cut to TF32 (10 mantissa bits) by `split_tf32`'s bit operations
    on an int32 view: rounded to nearest, ties away from zero, or
    truncated."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + (0x1000 if rounded else 0)) & -0x2000).view(
        torch.float32)


def _mm_tf32(passes: int):
    """a @ b as the kernels' mma.sync runs it: passes 3 is 3xTF32 (hi*hi +
    hi*lo + lo*hi; hi rounded, lo = x - hi truncated), passes 1 one TF32
    product of the rounded operands."""
    def mm(a, b):
        ah, bh = _tf32(a), _tf32(b)
        if passes == 1:
            return ah @ bh
        al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
        return al @ bh + ah @ bl + ah @ bh
    return mm


def _exact(a, b):
    return a @ b


def _ssd_bwd_twin(x, Bm, Cm, dt, A, D, S0, dy, dS, mm=_exact):
    B, T, nh = x.shape[:3]
    nc = -(-T // Q)
    x, Bm, Cm, dt, dy = (_pad(a, nc * Q) for a in (x, Bm, Cm, dt, dy))
    la = (dt * A).reshape(B, nc, Q, nh).permute(0, 1, 3, 2)  # [B,c,nh,Q]
    P_all = torch.cumsum(la, -1)
    xs, dys = (a.reshape(B, nc, Q, nh, -1).permute(0, 1, 3, 2, 4)
               for a in (x, dy))                          # [B,c,nh,Q,hp]
    Bs, Cs = (a.reshape(B, nc, 1, Q, -1) for a in (Bm, Cm))
    dts = dt.reshape(B, nc, Q, nh).permute(0, 1, 3, 2)    # [B,c,nh,Q]
    states, S = [], S0.clone()                 # the forward's chunk states
    for c in range(nc):
        states.append(S)
        P = P_all[:, c]
        w = torch.exp(P[..., -1:] - P) * dts[:, c]
        S = (S * torch.exp(P[..., -1])[..., None, None]
             + mm((xs[:, c] * w[..., None]).transpose(-1, -2), Bs[:, c]))
    dx, ddt = torch.zeros_like(xs), torch.zeros_like(dts)
    dB, dC = torch.zeros_like(Bs[:, :, 0]), torch.zeros_like(Cs[:, :, 0])
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    strict = torch.tril(torch.ones(Q, Q, dtype=torch.bool), -1)
    G = dS.clone()
    for c in reversed(range(nc)):              # G is the chunk's end's
        Sin = states[c]
        xc, dyc, Bc, Cc, dtc = xs[:, c], dys[:, c], Bs[:, c], Cs[:, c], \
            dts[:, c]
        eP = torch.exp(P_all[:, c])
        # exp(P_t - P_s) with P_t - P_s summed from step s + 1 on: [t, s].
        rel = torch.cumsum(torch.where(strict, la[:, c, :, :, None], 0.0),
                           -2)
        E = torch.where(causal, torch.exp(rel), 0.0)
        eLs = E[..., -1, :]
        CB = mm(Cc, Bc.transpose(-1, -2))                   # [B,1,t,s]
        DX = mm(dyc, xc.transpose(-1, -2))                  # [B,nh,t,s]
        Mp, Wc = E * CB, E * dtc[..., None, :] * DX
        W = Wc * CB
        GB = mm(Bc, G.transpose(-1, -2))                    # [B,nh,s,p]
        us = eLs * dtc * (xc * GB).sum(-1)
        dXt = eLs[..., None] * GB + mm(Mp.transpose(-1, -2), dyc)
        dx[:, c] = dtc[..., None] * dXt + D[:, None, None] * dyc
        SdY = mm(dyc, Sin)                                  # [B,nh,t,n]
        stY = eP * (Cc * SdY).sum(-1)
        dC[:, c] = (eP[..., None] * SdY + mm(Wc, Bc)).sum(1)
        dB[:, c] = ((eLs * dtc)[..., None] * mm(xc, G)
                    + mm(Wc.transpose(-1, -2), Cc)).sum(1)
        R = _rev(_excl(W, -1), -2).diagonal(dim1=-2, dim2=-1)
        dla = (eP[..., -1:] * (G * Sin).sum((-2, -1))[..., None]
               + _excl(us, -1) + _rev(stY, -1) + R)
        ddt[:, c] = (xc * dXt).sum(-1) + A[:, None] * dla
        dA += (dtc * dla).sum((0, 2))
        dD += DX.diagonal(dim1=-2, dim2=-1).sum((0, 2))
        G = (torch.exp(P_all[:, c, :, -1])[..., None, None] * G
             + mm((eP[..., None] * dyc).transpose(-1, -2), Cc))
    back = dx.permute(0, 1, 3, 2, 4).reshape(B, nc * Q, nh, -1)[:, :T]
    ddt = ddt.permute(0, 1, 3, 2).reshape(B, nc * Q, nh)[:, :T]
    return (back, dB.reshape(B, nc * Q, -1)[:, :T],
            dC.reshape(B, nc * Q, -1)[:, :T], ddt, dA, dD, G)


def _wkv_bwd_twin(r, k, v, lw, u, S0, dy, dS, mm=_exact):
    B, T, H, hd = r.shape
    nc = -(-T // Q)
    r, k, v, lw, dy = (_pad(a, nc * Q).permute(0, 2, 1, 3)
                       for a in (r, k, v, lw, dy))       # [B, H, T, hd]
    # Base-2 logarithms of the decays, cumulative within each chunk.
    C_all = torch.cat([torch.zeros((B, H, nc, 1, hd)), torch.cumsum(
        (lw * _LOG2E).reshape(B, H, nc, Q, hd), 3)], 3)
    states, S = [], S0.clone()                 # the forward's chunk states
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        states.append(S)
        C = C_all[:, :, c]
        Kh = k[:, :, sl] * torch.exp2(C[:, :, Q:] - C[:, :, 1:])
        S = (torch.exp2(C[:, :, Q])[..., None] * S
             + mm(Kh.transpose(-1, -2), v[:, :, sl]))
    dr, dk, dv, dlw = (torch.zeros_like(a) for a in (r, k, v, lw))
    du = torch.zeros_like(u)
    lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    strict = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)
    m, top, bot = SUB, slice(0, SUB), slice(SUB, Q)
    G = dS.clone()
    for c in reversed(range(nc)):              # G is the chunk's end's
        sl = slice(c * Q, (c + 1) * Q)
        rc, kc, vc, dyc = (a[:, :, sl] for a in (r, k, v, dy))
        Sin, C = states[c], C_all[:, :, c]
        EC = torch.exp2(C[:, :, :Q])                        # e^{C[t]}
        EL = torch.exp2(C[:, :, Q:] - C[:, :, 1:])          # e^{C[L]-C[s+1]}
        Fm = torch.exp2(C[:, :, m:m + 1] - C[:, :, 1:m + 1])    # s < m
        Em = torch.exp2(C[:, :, m:Q] - C[:, :, m:m + 1])        # t >= m
        Km, Rm = kc[:, :, top] * Fm, rc[:, :, bot] * Em
        dA_ = torch.where(lower, mm(dyc, vc.transpose(-1, -2)), 0.0)
        dAd = dA_.diagonal(dim1=-2, dim2=-1)[..., None]
        # The two diagonal 16 x 16 blocks, explicit: E3[b,h,blk,t,s,c].
        Cb = C[:, :, :Q].reshape(B, H, 2, SUB, 1, hd)
        Cs1 = C[:, :, 1:].reshape(B, H, 2, 1, SUB, hd)
        E3 = torch.where(strict[..., None], torch.exp2(Cb - Cs1), 0.0)
        rb, kb = (a.reshape(B, H, 2, SUB, hd) for a in (rc, kc))
        dAb = torch.stack([dA_[:, :, top, top], dA_[:, :, bot, bot]], 2)
        A_ = torch.zeros((B, H, Q, Q))
        Ad = (torch.einsum("bhxtc,bhxtsc,bhxsc->bhxts", rb, E3, kb)
              + torch.diag_embed((rb * u[:, None, None] * kb).sum(-1)))
        A_[:, :, top, top], A_[:, :, bot, bot] = Ad[:, :, 0], Ad[:, :, 1]
        A_[:, :, bot, top] = mm(Rm, Km.transpose(-1, -2))
        dr_d = torch.einsum("bhxts,bhxsc,bhxtsc->bhxtc", dAb, kb, E3)
        dk_d = torch.einsum("bhxts,bhxtc,bhxtsc->bhxsc", dAb, rb, E3)
        drc = (EC * mm(dyc, Sin.transpose(-1, -2)) + dr_d.reshape(rc.shape)
               + dAd * u[:, None] * kc)
        drc[:, :, bot] += Em * mm(dA_[:, :, bot, top], Km)
        Gv = mm(vc, G.transpose(-1, -2))                    # [s, c]
        dkc = EL * Gv + dk_d.reshape(kc.shape) + dAd * u[:, None] * rc
        dkc[:, :, top] += Fm * mm(dA_[:, :, bot, top].transpose(-1, -2), Rm)
        dv[:, :, sl] = mm(A_.transpose(-1, -2), dyc) + mm(kc * EL, G)
        dr[:, :, sl], dk[:, :, sl] = drc, dkc
        du += (dAd * rc * kc).sum((0, 2))
        dC = torch.zeros((B, H, Q + 1, hd))
        dC[:, :, :Q] += rc * (drc - dAd * u[:, None] * kc)
        dC[:, :, 1:] -= kc * (dkc - dAd * u[:, None] * rc)
        dC[:, :, Q] += ((kc * EL * Gv).sum(2)
                        + torch.exp2(C[:, :, Q]) * (G * Sin).sum(-1))
        dlw[:, :, sl] = _rev(dC, 2)[:, :, 1:]
        G = (torch.exp2(C[:, :, Q])[..., None] * G
             + mm((rc * EC).transpose(-1, -2), dyc))
    back = [a.permute(0, 2, 1, 3)[:, :T] for a in (dr, dk, dv, dlw)]
    return (*back, du, G)


@pytest.mark.parametrize("decay,T", [("weak", 77), ("strong", 64),
                                     ("weak", 130)])
def test_ssd_bwd_chunked_algebra_holds_f32_tolerance(decay, T):
    c = _t(_ssm_case(21, 2, T, 3, 32, 16, decay))
    if decay == "strong":
        assert (c["dt"][0, :32] * c["A"]).sum(0).max().item() < -88
    got = _ssd_bwd_twin(c["x"], c["Bm"], c["Cm"], c["dt"], c["A"], c["D"],
                        c["state"], c["dy"], c["dstate"])
    _assert_rel(got, _autograd_ssm(c, True), 2e-5, SSM_NAMES)


@pytest.mark.parametrize("decay_shift,T", [(-6.0, 77), (1.5, 64),
                                           (-1.5, 130)])
def test_wkv_bwd_chunked_algebra_holds_f32_tolerance(decay_shift, T):
    c = _t(_wkv_case(22, 2, T, 2, 32, decay_shift))
    if decay_shift > 0:
        assert c["lw"][0, :32].sum(0).min().item() < -88
    got = _wkv_bwd_twin(c["r"], c["k"], c["v"], c["lw"], c["u"],
                        c["state"], c["dy"], c["dstate"])
    _assert_rel(got, _autograd_wkv(c, True), 2e-5, WKV_NAMES)


def _rel_err(got, want) -> float:
    return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("kind", ["ssm_scan", "rwkv6_wkv"])
def test_bwd_products_need_3xtf32(kind):
    """Why every product of the two backward kernels runs in 3xTF32: with
    the tensor cores' TF32 rounding emulated (split_tf32's bit operations
    on an int32 view), the twins hold 2e-5 of max|want| at the models'
    widths (hp = N = 64, hd 64) in 3xTF32, and a single TF32 product per
    operand pair misses it by more than tenfold."""
    if kind == "ssm_scan":
        c = _t(_ssm_case(31, 1, 96, 2, 64, 64))
        args = [c[k] for k in ("x", "Bm", "Cm", "dt", "A", "D", "state",
                               "dy", "dstate")]
        twin, want = _ssd_bwd_twin, _autograd_ssm(c, True)
    else:
        c = _t(_wkv_case(32, 1, 96, 2, 64))
        args = [c[k] for k in ("r", "k", "v", "lw", "u", "state", "dy",
                               "dstate")]
        twin, want = _wkv_bwd_twin, _autograd_wkv(c, True)
    assert _rel_err(twin(*args, mm=_mm_tf32(3)), want) <= 2e-5
    assert _rel_err(twin(*args, mm=_mm_tf32(1)), want) > 2e-4


def test_tf32_split_emulation():
    """_tf32 keeps 10 mantissa bits, rounded to nearest with ties away from
    zero, or truncated; hi + lo of the split holds an f32 to ~2^-21."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + ulp])
    assert torch.equal(_tf32(x), torch.tensor([1 + ulp, 1.0, -(1 + ulp),
                                               1 + ulp]))
    assert _tf32(torch.tensor([1 + ulp * 0.99]), False).item() == 1.0
    a = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(
        np.float32))
    hi = _tf32(a)
    lo = _tf32(a - hi, False)
    assert ((hi - a).abs() <= a.abs() * 2.0 ** -11).all()
    assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -21).all()


def test_ssd_dla_needs_its_terms_summed_without_cancellation():
    """Why the kernel sums dla term by term: under a strong decay, the
    reverse sum of per-step dP terms (the direct chunked derivative) gives
    dA ~1e-3 off, far past 2e-5; the term-by-term sum holds it."""
    c = _t(_ssm_case(21, 2, 64, 3, 32, 16, "strong"))
    want = _autograd_ssm(c, True)[4]
    x, Bm, Cm, dt, A = (c[k] for k in ("x", "Bm", "Cm", "dt", "A"))
    got = _ssd_bwd_twin(x, Bm, Cm, dt, A, c["D"], c["state"], c["dy"],
                        c["dstate"])[4]
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-5
    # dla by the reverse sum: dla_t = sum_{tau >= t} dP_tau.
    B, nh = x.shape[0], x.shape[2]
    la = (dt * A).reshape(B, 2, Q, nh).permute(0, 1, 3, 2)     # [B,c,h,Q]
    P = torch.cumsum(la, -1)
    S, dA = c["state"].clone(), torch.zeros_like(A)
    G, gends, sts = c["dstate"].clone(), [None, None], []
    for ch in range(2):
        sts.append(S)
        S = ssm_scan_ref(x[:, 32 * ch:32 * ch + 32], Bm[:, 32 * ch:32 * ch
                         + 32], Cm[:, 32 * ch:32 * ch + 32],
                         dt[:, 32 * ch:32 * ch + 32], A, c["D"], S)[1]
    for ch in (1, 0):
        gends[ch] = G
        e = torch.exp(P[:, ch])
        sl = slice(32 * ch, 32 * ch + 32)
        G = (e[..., -1, None, None] * G + torch.einsum(
            "bht,bthp,btn->bhpn", e, c["dy"][:, sl], Cm[:, sl]))
    for ch in range(2):
        sl = slice(32 * ch, 32 * ch + 32)
        Pc = P[:, ch]
        E = torch.tril(torch.exp((Pc[..., :, None] - Pc[..., None, :])
                                 .clamp(max=0)))
        CB = torch.einsum("btn,bsn->bts", Cm[:, sl], Bm[:, sl])[:, None]
        DX = torch.einsum("bthp,bshp->bhts", c["dy"][:, sl], x[:, sl])
        dts = dt[:, sl].permute(0, 2, 1)
        W = E * CB * DX * dts[..., None, :]
        eLs = torch.exp(Pc[..., -1:] - Pc)
        GB = torch.einsum("bhpn,bsn->bhsp", gends[ch], Bm[:, sl])
        SC = torch.einsum("bhpn,btn->bhtp", sts[ch], Cm[:, sl])
        xh = x[:, sl].permute(0, 2, 1, 3)
        us = eLs * dts * (xh * GB).sum(-1)
        dP = (W.sum(-1) - W.sum(-2) - us + torch.exp(Pc) * (
            c["dy"][:, sl].permute(0, 2, 1, 3) * SC).sum(-1))
        dP[..., -1] += (torch.exp(Pc[..., -1]) * (gends[ch] * sts[ch]).sum(
            (-2, -1)) + us.sum(-1))
        dA += (dts * _rev(dP, -1)).sum((0, 2))
    assert ((dA - want).abs().max() / want.abs().max()).item() > 1e-4


# ------------------------------------------------ the ops on the CPU

def _chunk_states(ref, seqs, rest, state, T, chunk=32):
    """The state each `chunk`-step chunk starts from, [B, heads,
    ceil(T / chunk), ...], from the plain forward run chunk by chunk."""
    out = []
    for c0 in range(0, T, chunk):
        out.append(state)
        _, state = ref(*(a[:, c0:c0 + chunk] for a in seqs), *rest, state)
    return torch.stack(out, dim=2)


def _ssm_states(c):
    return _chunk_states(ssm_scan_ref, [c[k] for k in ("x", "Bm", "Cm",
                                                        "dt")],
                         [c["A"], c["D"]], c["state"], c["x"].shape[1])


def _wkv_states(w):
    return _chunk_states(rwkv6_wkv_ref, [w[k] for k in ("r", "k", "v",
                                                         "lw")],
                         [w["u"]], w["state"], w["r"].shape[1])


def test_cpu_backward_ops_take_the_plain_version_and_count_nothing():
    """On the CPU the ops read the state carried in (the first chunk's)
    from the chunk states, and give the plain version's gradients."""
    c = _t(_ssm_case(3, 1, 40, 2, 32, 16))
    n = ssm_scan_bwd.launches
    got = ssm_scan_bwd(c["x"], c["Bm"], c["Cm"], c["dt"], c["A"], c["D"],
                       _ssm_states(c), c["dy"], c["dstate"])
    want = ssm_scan_bwd_ref(c["x"], c["Bm"], c["Cm"], c["dt"], c["A"],
                            c["D"], c["state"], c["dy"], c["dstate"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ssm_scan_bwd.launches == n
    w = _t(_wkv_case(3, 1, 40, 2, 32))
    n = rwkv6_wkv_bwd.launches
    got = rwkv6_wkv_bwd(w["r"], w["k"], w["v"], w["lw"], w["u"],
                        _wkv_states(w), w["dy"], w["dstate"])
    want = rwkv6_wkv_bwd_ref(w["r"], w["k"], w["v"], w["lw"], w["u"],
                             w["state"], w["dy"], w["dstate"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert rwkv6_wkv_bwd.launches == n


@pytest.mark.parametrize("kind", ["ssm_scan", "rwkv6_wkv"])
def test_cpu_gradient_through_the_scan_ops_runs_the_plain_path(kind):
    """Under autograd a CPU call differentiates the plain version: the
    gradients equal the plain backward's, and no kernel is counted."""
    if kind == "ssm_scan":
        c = _t(_ssm_case(4, 1, 40, 2, 32, 16))
        keys = ("x", "Bm", "Cm", "dt", "A", "D", "state")
        op, bwd, bwd_op, fwd_op = ssm_scan, ssm_scan_bwd_ref, ssm_scan_bwd, \
            ssm_scan
    else:
        c = _t(_wkv_case(4, 1, 40, 2, 32))
        keys = ("r", "k", "v", "lw", "u", "state")
        op, bwd, bwd_op, fwd_op = rwkv6_wkv, rwkv6_wkv_bwd_ref, \
            rwkv6_wkv_bwd, rwkv6_wkv
    n = (fwd_op.launches, bwd_op.launches)
    leaves = [c[k].clone().requires_grad_() for k in keys]
    y, s = op(*leaves)
    grads = torch.autograd.grad((y * c["dy"]).sum() + (s * c["dstate"]).sum(),
                                leaves)
    want = bwd(*(c[k] for k in keys), c["dy"], c["dstate"])
    _assert_rel(grads, want, 1e-5, keys)
    assert (fwd_op.launches, bwd_op.launches) == n


def test_backward_ops_take_the_plain_version_only_on_the_cpu():
    """A tensor off the CPU (meta here) goes to the kernel's launcher,
    which wants CUDA, and is counted nowhere."""
    c = {k: v.to("meta") for k, v in _t(_ssm_case(5, 1, 40, 2, 32,
                                                     16)).items()}
    n = ssm_scan_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_bwd(c["x"], c["Bm"], c["Cm"], c["dt"], c["A"], c["D"],
                     torch.zeros((1, 2, 2, 32, 16), device="meta"), c["dy"])
    assert ssm_scan_bwd.launches == n
    w = {k: v.to("meta") for k, v in _t(_wkv_case(5, 1, 40, 2,
                                                     32)).items()}
    n = rwkv6_wkv_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_wkv_bwd(w["r"], w["k"], w["v"], w["lw"], w["u"],
                      torch.zeros((1, 2, 2, 32, 32), device="meta"), w["dy"])
    assert rwkv6_wkv_bwd.launches == n


def test_backward_launchers_refuse_cpu_tensors():
    c = _t(_ssm_case(6, 1, 40, 2, 32, 16))
    states = torch.zeros((1, 2, 2, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssm_bwd_kernel.ssm_scan_bwd(c["x"], c["Bm"], c["Cm"], c["dt"],
                                    c["A"], c["D"], states, c["dy"])
    w = _t(_wkv_case(6, 1, 40, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_bwd_kernel.rwkv6_wkv_bwd(w["r"], w["k"], w["v"], w["lw"],
                                     w["u"], torch.zeros((1, 2, 2, 32, 32)),
                                     w["dy"])


def test_unit_last_copies_only_what_the_kernels_cannot_read():
    like = torch.zeros(2, 3, 4)
    assert torch.equal(_grad.unit_last(None, like), like)
    g = torch.randn(2, 3, 4)
    assert _grad.unit_last(g, like) is g
    view = torch.randn(2, 4, 3).transpose(1, 2)
    assert _grad.unit_last(view, like).stride(-1) == 1
    broadcast = torch.ones(()).expand(2, 3, 4)           # from a sum()
    out = _grad.unit_last(broadcast, like)
    assert out.stride(-1) == 1 and torch.equal(out, torch.ones(2, 3, 4))
    assert _grad.wants_grad(None, g) is False
    assert _grad.wants_grad(None, g.requires_grad_())
    with torch.no_grad():
        assert _grad.wants_grad(g) is False
