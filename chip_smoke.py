#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit when it fails:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per kernel, in parallel) and print ptxas' register report;
  3. hold each kernel against its plain PyTorch version, run in f32 on the
     same inputs, at the serving paths' shapes: f32 at 2e-5 with TF32 off;
     bf16 at atol 4e-3 / rtol 1.6e-2 per element and 1e-2 relative per
     row (query row; last axis of a scan's y); attention with a ragged
     length, Tq != Tk, a query row with no admissible key, a sliding
     window, ring positions and empty-slot marks, and at zamba2's head dim
     112 (G = 1, window 4096); the two scans (ssm_scan, rwkv6_wkv) over a
     ragged T from a nonzero initial state, their final state at 2e-5;
  4. serve: AGH plans the paper's default instance, `to_deployment` turns
     the plan into pairs, and one full-width bf16 qwen2-0.5b engine (random
     weights from --seed) serves 8 requests of 600-999 prompt tokens
     (left-padded to 999, not a multiple of any kernel tile) for 32 new
     tokens each; then a full-width, full-depth bf16 rwkv6-7b engine and a
     zamba2-7b one serve the same requests, one engine at a time. Each
     path's kernel launch counts are set to 0 just before its run and read
     just after; every kernel of the path must have launched;
  5. run one full-width prefill + 4 decode steps on the kernels and on
     the plain versions, and compare the logits: in f32 at atol = rtol =
     1e-3; in bf16 (same bf16-rounded weights) at 5e-2 relative per logit
     row, and no more than twice as far from the f32 logits as the plain
     path; for qwen2-0.5b at full depth, rwkv6-7b at 4 layers and zamba2-7b
     at 7 (one super-block, the shared attention, one tail layer);
  6. time each kernel at the serving shapes with CUDA events, beside its
     plain version, one PyTorch call computing the same function where
     there is one (`F.scaled_dot_product_attention`, a yardstick the port
     never calls), the least time the card could take (its bound) and
     each kernel's time before its Hopper redesign (BEFORE_REDESIGN_MS,
     copied from PERF.md and printed in the table only, never in the JSON
     line);
  7. trace one more served batch of each model with torch.profiler: the
     device's busy share of the batch's wall time and the kernels that
     take the most;
  8. plan -> stress test on the card: `plan("agh", risk=...)` on the risk
     benchmark's instance (random_instance(20, 20, 20, seed=42)) runs the
     f64 Stage-2 risk solver on CUDA at S 20,000; then, warm, it times
     `risk_evaluate` of the gh plan at S 20,000 and 100,000,
     `rank_deployments` of both plans at 1.5x stress and a batch forced
     through restarted PDHG (max_anchors 0), and the same S 20,000 run on
     the CPU; it holds the first 2,000 scenarios' costs, and the forced
     batch's, against the exact HiGHS oracle at rtol 1e-5, checks that
     every run accounts for each scenario once, and profiles one run
     (device programs, host syncs, launches, busy share, peak memory).

Phase 8 prints its numbers as one JSON line {"risk": ...}. The line
before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the run fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: dense bf16 and TF32 tensor-core rates (the scans run
# their f32 products in 3xTF32, three TF32 products each), the f32 rate
# outside the tensor cores, and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

ARCH = "qwen2-0.5b"
# The recurrent models served after qwen2-0.5b, each with the kernels its
# path must launch, and the depth of its phase-5 logits check.
RECURRENT = {"rwkv6-7b": (("rwkv6_wkv",), 4),
             "zamba2-7b": (("ssm_scan", "flash_attention",
                            "decode_attention"), 7)}
PROMPT_LENS = [600 + 57 * i for i in range(8)]     # 600 .. 999
NEW_TOKENS = 32
# Kernels are held against their plain versions run in f32 on the same
# inputs (bf16 inputs upcast exactly). f32 kernels: IEEE f32 on both sides,
# 2e-5. bf16 kernels round the output to bf16 (2**-9 relative) and the
# attention kernels also round P to bf16 before P V, so per element
# atol 4e-3 / rtol 1.6e-2 (four bf16 roundings), and per query row
# |got - want|_2 / |want|_2 <= 1e-2. The roundings give a few 1e-3 there;
# phase 3 shows that the row bound rejects two faults the per-element one
# lets through or barely catches (`criterion_rejects`).
F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL, BF16_ROW_REL = 4e-3, 1.6e-2, 1e-2
E2E_TOL = 1e-3          # f32 logits, kernels vs plain, atol = rtol
# bf16 logits, kernels vs plain: largest |got - want|_2 / |want|_2 over the
# logit rows; and the kernel path may sit at most twice as far from the f32
# logits (same bf16-rounded weights) as the plain path does, plus E2E_TOL.
E2E_BF16_REL = 5e-2


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def model_layout(gen, B, T, heads, hd, dtype, dev):
    """A [B,T,heads,hd] tensor, handed over as its [B,heads,T,hd] view."""
    x = torch.randn((B, T, heads, hd), generator=gen, device=dev)
    return x.to(dtype).transpose(1, 2)


def time_ms(fns, n: int = 48) -> tuple[float, float]:
    """Per-call time of `fns` (called in turn, each on its own inputs, so
    that together they exceed the 50 MB L2 as the layer stack does):
    (device ms, from one CUDA-graph replay of n calls, so host launch cost
    is left out; eager ms, the same n calls launched from Python)."""
    calls = [fns[i % len(fns)] for i in range(n)]
    for fn in fns:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for fn in calls:
        fn()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / n
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for fn in calls:
            fn()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, eager


def bound(bytes_moved: float, flops: float,
          peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, tol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:g} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def row_rel(got, want) -> float:
    """Largest |got - want|_2 / |want|_2 over the last axis's rows."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def check_kernel(name, got, want) -> tuple[float, float]:
    """A kernel's output against its plain version run in f32 on the same
    inputs, at the tolerances above. Returns (max abs error, largest row
    relative error)."""
    if got.dtype == torch.float32:
        return check_close(name, got, want, F32_TOL), row_rel(got, want)
    err = (got.float() - want).abs().max().item()
    rel = row_rel(got, want)
    ok = (torch.allclose(got.float(), want, atol=BF16_ATOL, rtol=BF16_RTOL)
          and rel <= BF16_ROW_REL)
    print(f"  {name}: max_abs_err={err:.3e} (atol {BF16_ATOL:g} rtol "
          f"{BF16_RTOL:g}) max_row_rel_err={rel:.3e} (tol "
          f"{BF16_ROW_REL:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err, rel


def f32(*xs):
    return tuple(x.float() for x in xs)


def criterion_rejects(q, k, v, pos, attention_ref) -> None:
    """The bf16 row bound must reject two faults a flash kernel could
    have, made here on the plain version at the served shape and rounded
    to bf16: (a) the zero-padded keys past Tk of the last 64-key tile left
    in the softmax sum (logit 0) of the rows that reach that tile; (b) one
    64-key tile, keys 448..511, dropped."""
    T, tile = k.shape[2], 64
    want = attention_ref(*f32(q, k, v), pos, pos)
    pad, last = (-T) % tile, (T - 1) // tile * tile
    z = k.new_zeros(k.shape[:2] + (pad, k.shape[3]))
    faults = {
        f"{pad} padded keys in the last tile's softmax": attention_ref(
            *f32(q, torch.cat([k, z], 2), torch.cat([v, z], 2)), pos,
            torch.cat([pos, pos.new_full((pad,), last)])),
        "keys 448..511 dropped": attention_ref(
            *f32(q, k, v), pos,
            torch.where((pos >= 448) & (pos < 512), 2 ** 30, pos)),
    }
    for name, bad in faults.items():
        bad = bad.to(q.dtype)
        rel = row_rel(bad, want)
        elem = torch.allclose(bad.float(), want, atol=BF16_ATOL,
                              rtol=BF16_RTOL)
        print(f"  bf16 bound against a fault ({name}): max_row_rel_err="
              f"{rel:.3e}, per-element bound "
              f"{'passes it' if elem else 'rejects it'}, row bound "
              f"{'rejects it' if rel > BF16_ROW_REL else 'PASSES IT'}",
              flush=True)
        if rel <= BF16_ROW_REL:
            fail(f"the bf16 row bound does not reject a fault: {name}")


def check_kernels(dev, seed):
    """Phase 3. Returns the main-path bf16 inputs and each kernel's
    largest error at the main path's shapes."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    B, H, KV, hd = len(PROMPT_LENS), cfg.n_heads, cfg.n_kv_heads, cfg.hd
    T, S = max(PROMPT_LENS), max(PROMPT_LENS) + NEW_TOKENS
    gen = torch.Generator(device=dev).manual_seed(seed)
    # Per kernel and dtype: (max abs error, largest row relative error)
    # over the checks at the main path's shapes.
    errs = {(n, d): (0.0, 0.0)
            for n in ("flash_attention", "decode_attention")
            for d in ("float32", "bfloat16")}
    main = {}

    def keep(key, err):
        errs[key] = tuple(max(a, b) for a, b in zip(errs[key], err))

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        q, k, v = (model_layout(gen, B, T, h, hd, dtype, dev)
                   for h in (H, KV, KV))
        pos = torch.arange(T, dtype=torch.int32, device=dev)
        for window in (0, 256):
            err = check_kernel(
                f"flash_attention {tag} B={B} H={H} KV={KV} T={T} hd={hd} "
                f"window={window}", fk.flash_attention(q, k, v, pos, pos,
                                                       window),
                attention_ref(*f32(q, k, v), pos, pos, window))
            if window == 0:
                keep(("flash_attention", tag), err)
        # The last 77 queries over all T keys (Tq != Tk, both ragged); one
        # query precedes every key, so its row takes the uniform average.
        q_pos = torch.arange(T - 77, T, dtype=torch.int32, device=dev)
        q_pos[3] = -5
        for window in (0, 50):
            check_kernel(
                f"flash_attention {tag} Tq=77 of Tk={T}, a row with no "
                f"admissible key, window={window}",
                fk.flash_attention(q[:, :, -77:], k, v, q_pos, pos, window),
                attention_ref(*f32(q[:, :, -77:], k, v), q_pos, pos, window))
        if dtype == torch.bfloat16:
            main["flash"] = (q, k, v, pos)
            criterion_rejects(q, k, v, pos, attention_ref)

        qd = torch.randn((B, KV, H // KV, hd), generator=gen,
                         device=dev).to(dtype)
        kc, vc = (model_layout(gen, B, S, KV, hd, dtype, dev)
                  for _ in range(2))
        p = T + NEW_TOKENS // 2
        slots = torch.arange(S, device=dev)
        k_pos = torch.where(slots <= p, slots, 2 ** 30).to(torch.int32)
        keep(("decode_attention", tag), check_kernel(
            f"decode_attention {tag} B={B} KV={KV} G={H // KV} S={S} "
            f"hd={hd} pos={p}", dk.decode_attention(qd, kc, vc, k_pos, p),
            decode_attention_ref(*f32(qd, kc, vc), k_pos, p)))
        last = 2500                          # ring slot -> position map
        ring = last - ((last - slots) % S)
        ring[::9] = 2 ** 30                  # and some empty slots
        ring = ring.to(torch.int32)
        check_kernel(f"decode_attention {tag} ring+empty slots",
                     dk.decode_attention(qd, kc, vc, ring, last),
                     decode_attention_ref(*f32(qd, kc, vc), ring, last))
        if dtype == torch.bfloat16:
            main["decode"] = (qd, kc, vc, k_pos, p)
    return main, errs


def check_attention_hd112(dev, seed):
    """Phase 3, zamba2's shared attention: hd 112, G = 1, its 4096-token
    window, at the served batch's shapes. Returns the bf16 inputs and each
    kernel's largest bf16 (max abs, row relative) error."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    cfg = get_config("zamba2-7b")
    B, H, KV, hd = len(PROMPT_LENS), cfg.n_heads, cfg.n_kv_heads, cfg.hd
    W, T = cfg.sliding_window, max(PROMPT_LENS)
    S = T + NEW_TOKENS
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    main, errs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        q, k, v = (model_layout(gen, B, T, h, hd, dtype, dev)
                   for h in (H, KV, KV))
        pos = torch.arange(T, dtype=torch.int32, device=dev)
        e_f = check_kernel(
            f"flash_attention {tag} B={B} H={H} KV={KV} T={T} hd={hd} "
            f"window={W}", fk.flash_attention(q, k, v, pos, pos, W),
            attention_ref(*f32(q, k, v), pos, pos, W))
        qd = torch.randn((B, KV, 1, hd), generator=gen, device=dev).to(dtype)
        kc, vc = (model_layout(gen, B, S, KV, hd, dtype, dev)
                  for _ in range(2))
        p = T + NEW_TOKENS // 2
        slots = torch.arange(S, device=dev)
        k_pos = torch.where(slots <= p, slots, 2 ** 30).to(torch.int32)
        e_d = check_kernel(
            f"decode_attention {tag} B={B} KV={KV} G=1 S={S} hd={hd} "
            f"pos={p}", dk.decode_attention(qd, kc, vc, k_pos, p),
            decode_attention_ref(*f32(qd, kc, vc), k_pos, p))
        if dtype == torch.bfloat16:
            main = {"flash": (q, k, v, pos, W),
                    "decode": (qd, kc, vc, k_pos, p)}
            errs = {"flash_attention": e_f, "decode_attention": e_d}
    return main, errs


def scan_inputs(kind, dtype, gen, dev, T=None):
    """Inputs of a scan at the served batch's shape (B 8, T 999), drawn as
    the reference's kernel sweep draws them (tests/test_kernels.py), and a
    nonzero initial state: ssm_scan at zamba2's widths (nh 112, hp 64,
    N 64), rwkv6_wkv at rwkv6-7b's (H 64, hd 64)."""
    B, T = len(PROMPT_LENS), T or max(PROMPT_LENS)

    def randn(shape, scale=1.0, dt=torch.float32):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x.to(dt)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    if kind == "ssm_scan":
        nh, hp, N = 112, 64, 64
        return (randn((B, T, nh, hp), dt=dtype),
                randn((B, T, N), 0.5, dtype), randn((B, T, N), 0.5, dtype),
                uniform((B, T, nh), 0.001, 0.1), -uniform((nh,), 0.5, 2.0),
                randn((nh,)), randn((B, nh, hp, N)))
    H, hd = 64, 64
    r, k, v = (randn((B, T, H, hd), 0.5, dtype) for _ in range(3))
    lw = (-torch.exp(randn((B, T, H, hd), 0.5) - 1.5)).to(dtype)
    return r, k, v, lw, randn((H, hd), 0.5), randn((B, H, hd, hd))


def check_scans(dev, seed):
    """Phase 3 for the two scans at the served shapes: f32 and bf16, over
    a ragged T (999 and 77 are no multiple of the 64-step chunk), from a
    nonzero initial state and from zeros; y as every kernel, the final
    state (f32 either way) at 2e-5. Returns the f32 inputs (what the
    models pass) and each kernel's largest errors by dtype."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    fns = {"ssm_scan": (sk.ssm_scan, ssm_scan_ref, 3),
           "rwkv6_wkv": (wk.rwkv6_wkv, rwkv6_wkv_ref, 4)}
    main, errs = {}, {}
    for name, (kern, plain, n_cast) in fns.items():
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            *ins, s0 = scan_inputs(name, dtype, gen, dev)
            # The plain version in f32 on the same (exactly upcast) inputs.
            ins32 = [*f32(*ins[:n_cast]), *ins[n_cast:]]
            shape = "x".join(str(n) for n in ins[0].shape)
            err = (0.0, 0.0)
            for label, sl, state in (("", slice(None), s0),
                                     (" from zeros", slice(None), None),
                                     (" T=77", slice(0, 77), s0)):
                cut = [a[:, sl] if a.dim() >= 3 else a for a in ins]
                cut32 = [a[:, sl] if a.dim() >= 3 else a for a in ins32]
                y, s_out = kern(*cut, state)
                want_y, want_s = plain(*cut32, state)
                e = check_kernel(f"{name} {tag} [{shape}]{label}, y", y,
                                 want_y)
                check_close(f"{name} {tag} [{shape}]{label}, final state",
                            s_out, want_s, F32_TOL)
                err = tuple(max(a, b) for a, b in zip(err, e))
            errs[name, tag] = err
            if dtype == torch.float32:
                main[name] = (*ins, s0)
    return main, errs


def kernel_ops() -> dict:
    """Each kernel's public op, which counts its launches."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    return {"flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "ssm_scan": ssm_scan, "rwkv6_wkv": rwkv6_wkv}


def serve_counted(engine, reqs, kernels, label, seed):
    """Serve `reqs` once with every launch count set to 0 just before and
    read just after, then twice more for the spread of the host-clock
    numbers. Fails unless each of `kernels` launched and every request
    got its tokens. Returns the counts."""
    from repro_torch.launch import serve

    cfg = engine.cfg
    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
    stats = serve.serve_batch(engine, reqs)
    launches = {name: op.launches for name, op in ops.items()}
    print(f"  kernel launches in that run: {launches}")
    runs = [stats] + [serve.serve_batch(engine, serve.make_requests(
        PROMPT_LENS, NEW_TOKENS, cfg.vocab_size, seed)) for _ in range(2)]
    T = max(PROMPT_LENS)
    print(f"  served {len(reqs)} requests, prompts {min(PROMPT_LENS)}-{T} "
          f"(padded to {T}), {NEW_TOKENS} new tokens each, on {label} "
          f"bf16, 3 runs: TTFT ms "
          f"{[round(r['ttft_s'] * 1e3, 2) for r in runs]}, tok/s "
          f"{[round(r['tok_per_s'], 1) for r in runs]}, wall s "
          f"{[round(r['wall_s'], 3) for r in runs]}", flush=True)
    for r in reqs:
        if len(r.output) != NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            fail(f"request {r.rid} got {len(r.output)} tokens {r.output}")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"the served {label} batch never launched {name}")
    return launches


def serve_main_path(dev, seed):
    """Phase 4: plan -> deploy -> serve through the launcher's functions.
    Returns the engine, the requests and the kernels' launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    inst, sol, spec = serve.plan_fleet(seed)
    print(f"  AGH plan in {time.perf_counter() - t0:.2f}s: "
          f"{len(spec.pairs)} pairs "
          f"{[(p.model, p.tier, p.tp, p.pp) for p in spec.pairs]}")
    if not spec.pairs:
        fail("the plan deploys no pair")
    cfg = get_config(ARCH)
    T = max(PROMPT_LENS)
    engine = serve.build_engine(cfg, dev, seed, max_len=T + NEW_TOKENS,
                                max_batch=len(PROMPT_LENS))
    # Warm-up batch (library handles, allocator); not counted.
    serve.serve_batch(engine, serve.make_requests([16, 9], 2,
                                                  cfg.vocab_size, seed + 1))
    reqs = serve.make_requests(PROMPT_LENS, NEW_TOKENS, cfg.vocab_size, seed)
    launches = serve_counted(engine, reqs,
                             ("flash_attention", "decode_attention"), ARCH,
                             seed)
    return engine, reqs, launches


def serve_recurrent(arch, dev, seed):
    """Phase 4 for a recurrent model: one full-width, full-depth bf16
    engine, random weights from `seed`, serves the batch, and phase 7
    traces one more batch, before the engine is freed for the next.
    Returns the launch counts and the trace's summary."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config(arch)
    T = max(PROMPT_LENS)
    t0 = time.perf_counter()
    engine = serve.build_engine(cfg, dev, seed, max_len=T + NEW_TOKENS,
                                max_batch=len(PROMPT_LENS))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(engine.params))
    print(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_par / 1e9:.2f} B parameters drawn in "
          f"{time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated",
          flush=True)
    serve.serve_batch(engine, serve.make_requests([16, 9], 2,
                                                  cfg.vocab_size, seed + 1))
    reqs = serve.make_requests(PROMPT_LENS, NEW_TOKENS, cfg.vocab_size, seed)
    launches = serve_counted(engine, reqs, RECURRENT[arch][0], arch, seed)
    print(f"  peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB "
          f"allocated so far")
    phase(f"7. device trace of one served {arch} batch")
    trace = trace_batch(engine, reqs)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches, trace


def trace_batch(engine, reqs):
    """Phase 7: the served batch again, under torch.profiler. Returns
    (busy share, wall ms, busy ms, launches), or None when the profiler
    saw no CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    fresh = [dataclasses.replace(r, output=[], first_token_s=None,
                                 done_s=None) for r in reqs]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = serve.serve_batch(engine, fresh)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if not rows:
        print("  device trace: not measured (the profiler saw no CUDA "
              "kernels)")
        return None
    wall_ms = stats["wall_s"] * 1e3
    n = sum(e.count for e in rows)
    print(f"  traced batch wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% busy), "
          f"{n} kernel launches")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:6d}x  {e.key[:90]}")
    return dict(busy=busy_ms / wall_ms, wall_ms=wall_ms, busy_ms=busy_ms,
                launches=n)


def compare_paths(dev, seed, arch=ARCH, n_layers=None):
    """Phase 5: full-width prefill + 4 decode steps, kernels vs plain, in
    f32 and in bf16 on the same bf16-rounded weights; `n_layers` cuts the
    depth."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import decoder

    cfg16 = get_config(arch)
    if n_layers:
        cfg16 = dataclasses.replace(cfg16, n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    params16 = decoder.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg16)
    params32 = _tree_map(lambda x: x.float(), params16)
    B, T, n_dec = 2, max(PROMPT_LENS), 4
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    toks = torch.randint(1, cfg16.vocab_size, (B, T + n_dec), generator=gen,
                         device=dev)
    name = f"{cfg16.name} ({cfg16.n_layers} layers)"

    def run(params, cfg, use_kernels):
        with torch.inference_mode():
            lg, cache = decoder.prefill(params, cfg, toks[:, :T],
                                        max_len=T + n_dec,
                                        use_kernels=use_kernels)
            out = [lg]
            for t in range(T, T + n_dec):
                lg, cache = decoder.decode_step(params, cfg, cache,
                                                toks[:, t:t + 1], t,
                                                use_kernels=use_kernels)
                out.append(lg)
        got = torch.cat(out, dim=1)
        if not torch.isfinite(got).all():
            fail(f"non-finite {cfg.dtype} logits of {name} "
                 f"(kernels={use_kernels})")
        return got.float()

    got, want = run(params32, cfg32, True), run(params32, cfg32, False)
    print(f"  {name} logits scale: max |plain| = "
          f"{want.abs().max().item():.3f}")
    check_close(f"f32 {name} prefill T={T} + {n_dec} decode steps, "
                f"kernels vs plain", got, want, E2E_TOL)
    got16, want16 = run(params16, cfg16, True), run(params16, cfg16, False)
    rel = row_rel(got16, want16)
    rel_k, rel_p = row_rel(got16, want), row_rel(want16, want)
    ok = rel <= E2E_BF16_REL and rel_k <= 2 * rel_p + E2E_TOL
    same = (got16.argmax(-1) == want16.argmax(-1)).float().mean().item()
    print(f"  bf16 {name} prefill T={T} + {n_dec} decode steps: "
          f"max_row_rel_err kernels vs plain {rel:.3e} (tol "
          f"{E2E_BF16_REL:g}); vs the f32 logits: kernels {rel_k:.3e}, "
          f"plain {rel_p:.3e} (tol 2x plain + {E2E_TOL:g}); same greedy "
          f"token in {same:.3f} of rows {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail(f"bf16 logits of {name}'s kernel path disagree with the "
             f"plain path")
    del params16, params32
    gc.collect()
    torch.cuda.empty_cache()


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _time_flash(q, k, v, pos, window, n_sets):
    """Flash kernel, plain version and SDPA on `n_sets` copies of the
    inputs (together past the 50 MB L2, as distinct layers are)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, H, T, hd = q.shape
    fl = [(q, k, v)] + [tuple(x.clone(memory_format=torch.preserve_format)
                              for x in (q, k, v)) for _ in range(n_sets - 1)]
    ms, eager = time_ms([lambda a=a: fk.flash_attention(*a, pos, pos, window)
                         for a in fl])
    adm = pos[None, :] <= pos[:, None]
    if window > 0:
        adm &= pos[None, :] > pos[:, None] - window
    pairs = int(adm.sum().item())
    b, t = bound(q.element_size() * (2 * q.numel() + k.numel() + v.numel())
                 + 4 * 2 * T, 4.0 * B * H * hd * pairs)
    # SDPA's causal mask is the same function when the window covers T.
    lib = (time_ms([lambda a=a: F.scaled_dot_product_attention(
        *a, is_causal=True, enable_gqa=True) for a in fl])[0]
        if window == 0 or window >= T else None)
    return dict(ms=ms, eager_ms=eager,
                plain_ms=time_ms([lambda a=a: attention_ref(*a, pos, pos,
                                                            window)
                                  for a in fl])[0],
                bound_ms=b, bound_by=t, library_ms=lib,
                shape=f"B={B} H={H} KV={k.shape[1]} T={T} hd={hd} "
                      f"{str(q.dtype).split('.')[-1]} causal"
                      + (f" window={window}" if window else ""))


def _time_decode(qd, kc, vc, k_pos, p, n_caches):
    """Decode kernel, plain version and SDPA over `n_caches` caches (one
    per layer, as a decode step reads them)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    B, KV, G, hd = qd.shape
    S = kc.shape[2]
    valid = k_pos <= p
    n_valid = int(valid.sum().item())
    b, t = bound(qd.element_size() * (2 * qd.numel()
                                      + 2 * B * KV * n_valid * hd) + 4 * S,
                 4.0 * B * KV * G * hd * n_valid)
    qh = qd.reshape(B, KV * G, 1, hd)
    mask = valid[None, None, None, :]
    caches = [(kc, vc)] + [(kc.clone(memory_format=torch.preserve_format),
                            vc.clone(memory_format=torch.preserve_format))
                           for _ in range(n_caches - 1)]
    ms, eager = time_ms([lambda c=c: dk.decode_attention(qd, *c, k_pos, p)
                         for c in caches])
    return dict(ms=ms, eager_ms=eager,
                plain_ms=time_ms([lambda c=c: decode_attention_ref(
                    qd, *c, k_pos, p) for c in caches])[0],
                bound_ms=b, bound_by=t,
                library_ms=time_ms([lambda c=c: F.scaled_dot_product_attention(
                    qh, *c, attn_mask=mask, enable_gqa=True)
                    for c in caches])[0],
                shape=f"B={B} KV={KV} G={G} S={S} valid={n_valid} hd={hd} "
                      f"{str(qd.dtype).split('.')[-1]}")


def _time_scan(name, ins):
    """A scan kernel and its plain (stepwise) version on the served shape's
    f32 inputs, from a nonzero state. The bound counts the recurrence's own
    work, 4 flops (two multiply-adds) per state element per step, plus one
    exponential per decay, each input read once, y and the final state
    written once. `bound_ms` takes the flops in the kernels' own units,
    3xTF32 (three TF32 tensor-core products per f32 one) at 495 TFLOP/s;
    `bound_f32_ms` at the f32 rate outside the tensor cores, as the scalar
    kernels were bounded before."""
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    *args, s0 = ins
    kern, plain = ((sk.ssm_scan, ssm_scan_ref) if name == "ssm_scan"
                   else (wk.rwkv6_wkv, rwkv6_wkv_ref))
    x = args[0]
    B, T = x.shape[:2]
    n_in = sum(a.numel() * a.element_size() for a in args)
    state_bytes = 2 * s0.numel() * 4
    y_bytes = x.numel() * x.element_size()
    decays = args[3].numel() if name == "ssm_scan" else x.numel()
    flops = 4.0 * T * s0.numel() + decays
    n_bytes = n_in + y_bytes + state_bytes
    b, t = bound(n_bytes, 3 * flops, PEAK_TF32_FLOPS)
    ms, eager = time_ms([lambda: kern(*args, s0)], n=20)
    return dict(ms=ms, eager_ms=eager,
                plain_ms=time_ms([lambda: plain(*args, s0)], n=2)[0],
                bound_ms=b, bound_by=t, bound_peak="3xTF32 at 495 TFLOP/s",
                bound_f32_ms=bound(n_bytes, flops, PEAK_F32_FLOPS)[0],
                library_ms=None,
                shape="x".join(str(n) for n in x.shape) + " f32, state "
                      + "x".join(str(n) for n in s0.shape))


# Each kernel's phase-6 time before its Hopper redesign (the kernel table of
# PERF.md, same shapes, NVIDIA H100 80GB HBM3 at 700 W): (qwen2-0.5b's
# shape, zamba2-7b's hd-112 shape) for attention, the served shape for the
# scans. Not measured by this run, so printed beside the table for reading
# only and kept out of the JSON line.
BEFORE_REDESIGN_MS = {"flash_attention": (0.3246, 1.4885),
                      "decode_attention": (0.0271, 0.4944),
                      "ssm_scan": (1.5947,),
                      "rwkv6_wkv": (1.5367,)}


SOURCES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:83",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:79",
    "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:75",
    "rwkv6_wkv": "src/repro/kernels/rwkv6_wkv/kernel.py:74",
}


def time_kernels(main, errs, launches_by_path):
    """Phase 6: the kernel table. The attention rows time the qwen2-0.5b
    shapes, with zamba2's hd-112 shapes under "hd112"; the scans time the
    served recurrent shapes."""
    q, k, v, pos = main["flash"]
    qd, kc, vc, k_pos, p = main["decode"]
    timed = {
        "flash_attention": _time_flash(q, k, v, pos, 0, 4),
        "decode_attention": _time_decode(qd, kc, vc, k_pos, p, 24),
        "ssm_scan": _time_scan("ssm_scan", main["ssm_scan"]),
        "rwkv6_wkv": _time_scan("rwkv6_wkv", main["rwkv6_wkv"]),
    }
    q, k, v, pos, window = main["hd112"]["flash"]
    timed["flash_attention"]["hd112"] = dict(
        _time_flash(q, k, v, pos, window, 2),
        max_abs_err=errs["hd112"]["flash_attention"][0],
        max_row_rel_err=errs["hd112"]["flash_attention"][1])
    timed["decode_attention"]["hd112"] = dict(
        _time_decode(*main["hd112"]["decode"], 13),
        max_abs_err=errs["hd112"]["decode_attention"][0],
        max_row_rel_err=errs["hd112"]["decode_attention"][1])
    rows = []
    for name, t in timed.items():
        # The attention kernels run bf16 on the served paths, the scans f32
        # (the models upcast before them).
        main_dt, other = (("bfloat16", "float32") if "attention" in name
                          else ("float32", "bfloat16"))
        by_path = {path: n[name] for path, n in launches_by_path.items()
                   if n[name]}
        rows.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=SOURCES[name], launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=errs[name, main_dt][0],
            max_row_rel_err=errs[name, main_dt][1],
            **{("f32" if other == "float32" else "bf16") + "_max_abs_err":
               errs[name, other][0]},
            **t))
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        before = BEFORE_REDESIGN_MS[r["name"]]
        f32_bound = (f", at the f32 rate {r['bound_f32_ms']:.4f} ms"
                     if "bound_f32_ms" in r else "")
        print(f"  {r['name']} [{r['shape']}]: {r['ms']:.4f} ms (before the "
              f"redesign, from PERF.md: {before[0]:.4f} ms) (eager "
              f"{r['eager_ms']:.4f} "
              f"ms), plain {r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}){f32_bound}, "
              f"launches {r['launches_by_path']}")
        if "hd112" in r:
            h = r["hd112"]
            print(f"    at hd 112 [{h['shape']}]: {h['ms']:.4f} ms "
                  f"(before the redesign, from PERF.md: {before[1]:.4f} "
                  f"ms) (eager "
                  f"{h['eager_ms']:.4f} ms), plain "
                  f"{h['plain_ms']:.4f} ms, SDPA {h['library_ms']:.4f} ms, "
                  f"bound {h['bound_ms']:.4f} ms ({h['bound_by']})")
    return rows


# Phase 8: the risk benchmark's instance (benchmarks/risk_scaling.py), its
# scenario counts (the protocol's default and S_LIST_FULL's largest), the
# count up to which it measures the exact oracle before extrapolating, and
# the size of the batch forced through restarted PDHG.
RISK_SIZE, RISK_SEED = (20, 20, 20), 42
RISK_S = (20_000, 100_000)
RISK_ORACLE_S = 2_000
RISK_FORCED_S = 1024
RISK_RTOL = 1e-5


def risk_counts() -> dict:
    """The risk solver's device programs run and device-to-host copies made
    so far (candidate calls, PDHG blocks, host syncs)."""
    from repro_torch.risk import solver as rs
    return {"candidate_calls": rs._candidate_kernel.calls,
            "pdhg_blocks": rs._pdhg_block.calls,
            "host_syncs": rs._to_host.syncs}


def reset_risk_counts() -> None:
    from repro_torch.risk import solver as rs
    rs._candidate_kernel.calls = rs._pdhg_block.calls = 0
    rs._to_host.syncs = 0


def check_accounting(label, diag, S) -> None:
    """Every scenario lands in exactly one of the solver's buckets."""
    n = (diag["n_anchor0"] + diag["n_harvest_exact"] + diag["n_pdhg"]
         + diag["n_fallback_exact"])
    if n != S:
        fail(f"{label}: the diagnostics account for {n} of {S} scenarios "
             f"({diag})")


def check_oracle(label, got, want) -> float:
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    ok = rel <= RISK_RTOL
    print(f"  {label}: {len(got)} scenarios, largest relative cost error "
          f"vs the exact oracle {rel:.3e} (tol {RISK_RTOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{label} disagrees with the exact oracle")
    return rel


def timed_risk(label, fn, S):
    """Run `fn` (-> RiskReport) once on the card with the counts set to 0
    just before; returns (report, wall s, counts)."""
    reset_risk_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = risk_counts()
    check_accounting(label, rep.diagnostics, S)
    d = rep.diagnostics
    print(f"  {label}: {wall:.3f} s, E[cost] {rep.expected_cost:.4f}, "
          f"CVaR_0.95 {rep.cvar['0.95']:.4f}, anchors {d['n_anchors']}, "
          f"anchor0 {d['n_anchor0']}, harvests {d['n_harvest_exact']}, "
          f"pdhg {d['n_pdhg']}, fallbacks {d['n_fallback_exact']}; "
          f"{counts}", flush=True)
    return rep, wall, counts


def split_risk_time(fn) -> dict:
    """One more run of `fn`, with the host's time inside the solver's
    device programs (issuing their launches), inside its device-to-host
    copies (waiting for the device included) and elsewhere (numpy, HiGHS,
    Python) taken apart by timing each call of the three functions."""
    from repro_torch.risk import solver as rs

    spent = {"_candidate_kernel": 0.0, "_pdhg_block": 0.0, "_to_host": 0.0}
    originals = {name: getattr(rs, name) for name in spent}

    def timed(name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return originals[name](*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        # The originals count through their module-level names, which are
        # this wrapper while it is installed: this run is not counted.
        call.calls = call.syncs = 0
        return call

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for name in spent:
            setattr(rs, name, timed(name))
        fn()
        torch.cuda.synchronize()
    finally:
        for name, f in originals.items():
            setattr(rs, name, f)
    wall = time.perf_counter() - t0
    split = {"wall_s": wall,
             "programs_s": spent["_candidate_kernel"] + spent["_pdhg_block"],
             "copies_s": spent["_to_host"]}
    split["other_host_s"] = wall - split["programs_s"] - split["copies_s"]
    print(f"  host time of one more run: {wall:.3f} s = issuing device "
          f"programs {split['programs_s']:.3f} s + device-to-host copies "
          f"(waits included) {split['copies_s']:.3f} s + other host work "
          f"{split['other_host_s']:.3f} s", flush=True)
    return split


def profile_risk(fn) -> dict:
    """One more run of `fn` under torch.profiler (device activity only):
    CUDA kernels launched, device busy time (kernels and copies) and its
    share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print("  device trace: not measured (the profiler saw no CUDA "
              "kernels)")
        return {"launches": None, "busy_ms": None, "busy": None,
                "traced_wall_ms": wall_ms}
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    copies = [e for e in rows if e.key.startswith(("Memcpy", "Memset"))]
    launches = sum(e.count for e in rows) - sum(e.count for e in copies)
    print(f"  traced run {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy), {launches} kernel "
          f"launches, {sum(e.count for e in copies)} copies/sets")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
              f"{e.count:7d}x  {e.key[:90]}")
    return {"launches": launches, "busy_ms": busy_ms,
            "busy": busy_ms / wall_ms, "traced_wall_ms": wall_ms}


def risk_stress_test() -> dict:
    """Phase 8: plan -> stress test on the card, through the port's entry
    points. Returns the phase's numbers."""
    from repro_torch.core import ScenarioBatch, random_instance
    from repro_torch.core.stage2 import Stage2System
    from repro_torch.planner import PlanOptions, plan
    from repro_torch.risk import rank_deployments, risk_evaluate
    from repro_torch.risk.api import PROTOCOL
    from repro_torch.risk.solver import BatchedStage2Solver
    from repro_torch.risk.solver_exact import ExactChunkSolver

    out = {}
    inst = random_instance(*RISK_SIZE, seed=RISK_SEED)
    t0 = time.perf_counter()
    res = plan("agh", instance=inst,
               options=PlanOptions(risk={"S": RISK_S[0]}))
    out["plan_with_risk_s"] = time.perf_counter() - t0
    row = res.diagnostics["risk"]
    check_accounting("plan(risk=...)", row, RISK_S[0])
    print(f"  plan('agh', risk={{'S': {RISK_S[0]}}}) on {RISK_SIZE} seed "
          f"{RISK_SEED} (first, cold run): {out['plan_with_risk_s']:.2f} s; "
          f"objective {res.objective:.4f}; risk {row}", flush=True)
    agh_plan = res.solution
    gh_plan = plan("gh", instance=inst).solution

    # The first chunk of the S 20,000 stream, solved as risk_evaluate's
    # first chunk is (a fresh solver), against the oracle on its first
    # 2,000 scenarios; the oracle's wall is measured there.
    system = Stage2System(inst, gh_plan)
    kw = dict(d_infl=PROTOCOL["d_infl"], e_infl=PROTOCOL["e_infl"],
              lam_pm=PROTOCOL["lam_pm"])
    first = next(inst.perturbed_chunks(np.random.default_rng(PROTOCOL["seed"]),
                                       RISK_S[0], chunk=8192, **kw))
    card = BatchedStage2Solver(system).solve_scenarios(first)
    head = ScenarioBatch(S=RISK_ORACLE_S, tau=first.tau[:RISK_ORACLE_S],
                         e_base=first.e_base[:RISK_ORACLE_S],
                         lam=first.lam[:RISK_ORACLE_S])
    t0 = time.perf_counter()
    exact = ExactChunkSolver(system).solve_scenarios(head)
    out["exact_wall_s"] = {RISK_ORACLE_S: time.perf_counter() - t0}
    for S in RISK_S:
        out["exact_wall_s"][S] = (out["exact_wall_s"][RISK_ORACLE_S]
                                  * S / RISK_ORACLE_S)
    out["oracle_max_rel_err"] = check_oracle(
        f"gh plan, first {RISK_ORACLE_S} of S={RISK_S[0]}",
        card.costs[:RISK_ORACLE_S], exact.costs)
    print(f"  exact oracle (HiGHS, host): {out['exact_wall_s'][RISK_ORACLE_S]:.3f}"
          f" s for {RISK_ORACLE_S} scenarios; extrapolated "
          + ", ".join(f"{out['exact_wall_s'][S]:.1f} s at S={S}"
                      for S in RISK_S), flush=True)

    # Timed runs, warm (the plan's run above built the library handles).
    out["runs"] = {}
    for S in RISK_S:
        if S == RISK_S[-1]:
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        _, wall, counts = timed_risk(
            f"risk_evaluate(gh plan, S={S})",
            lambda S=S: risk_evaluate(inst, gh_plan, S=S), S)
        out["runs"][f"gh_S{S}"] = dict(wall_s=wall, **counts)
    # The run's own peak, above what earlier phases still hold.
    out["peak_mem_gib"] = ((torch.cuda.max_memory_allocated() - held)
                           / 2 ** 30)
    print(f"  peak device memory of the S={RISK_S[-1]} run: "
          f"{out['peak_mem_gib']:.3f} GiB above the {held / 2 ** 30:.3f} GiB "
          f"held before it")

    reset_risk_counts()
    t0 = time.perf_counter()
    rk = rank_deployments(inst, {"gh": gh_plan, "agh": agh_plan},
                          S=RISK_S[0], stress=1.5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name, rep in rk["reports"].items():
        check_accounting(f"rank_deployments {name}", rep.diagnostics,
                         RISK_S[0])
    out["runs"][f"rank_S{RISK_S[0]}_stress1.5"] = dict(wall_s=wall,
                                                       **risk_counts())
    buckets = ("n_anchors", "n_anchor0", "n_harvest_exact", "n_pdhg",
               "n_fallback_exact")
    diags = {k: {b: row[b] for b in buckets}
             for k, row in rk["summaries"].items()}
    print(f"  rank_deployments(gh, agh, S={RISK_S[0]}, stress 1.5): "
          f"{wall:.3f} s; by expected cost {rk['ranking_expected']}, by "
          f"CVaR_0.95 {rk['ranking_cvar']}; {diags}; {risk_counts()}",
          flush=True)

    # Restarted PDHG, forced: the anchor set frozen at the seed anchor.
    forced = inst.perturbed_batch(np.random.default_rng(5), RISK_FORCED_S,
                                  **kw)
    solver = BatchedStage2Solver(system, max_anchors=0)
    reset_risk_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = solver.solve_scenarios(forced)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = solver.diagnostics
    check_accounting("forced PDHG", d, RISK_FORCED_S)
    print(f"  forced PDHG batch S={RISK_FORCED_S}: {wall:.3f} s, {d}, "
          f"{risk_counts()}", flush=True)
    if d["n_pdhg"] <= 0:
        fail("the forced batch never ran PDHG")
    out["runs"][f"forced_pdhg_S{RISK_FORCED_S}"] = dict(
        wall_s=wall, pdhg_iters=d["pdhg_iters_max"], n_pdhg=d["n_pdhg"],
        n_fallback_exact=d["n_fallback_exact"], **risk_counts())
    out["forced_max_rel_err"] = check_oracle(
        f"forced PDHG S={RISK_FORCED_S}", got.costs,
        ExactChunkSolver(system).solve_scenarios(forced).costs)

    # The port on the host CPU, same machine, same run.
    t0 = time.perf_counter()
    rep = risk_evaluate(inst, gh_plan, S=RISK_S[0], device="cpu")
    out["cpu_wall_s"] = time.perf_counter() - t0
    check_accounting("risk_evaluate on the CPU", rep.diagnostics, RISK_S[0])
    print(f"  the same S={RISK_S[0]} run with device='cpu': "
          f"{out['cpu_wall_s']:.3f} s ({torch.get_num_threads()} threads)")

    run = lambda: risk_evaluate(inst, gh_plan, S=RISK_S[0])
    t0 = time.perf_counter()
    out["profile"] = profile_risk(run)
    print(f"  (profiling took {time.perf_counter() - t0:.1f} s)")
    out["host_split"] = split_risk_time(run)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import resolve_device

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    phase("2. build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")
    print(f"  built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s")

    phase("3. kernels vs plain versions")
    main_inputs, errs = check_kernels(dev, args.seed)
    main_inputs["hd112"], errs["hd112"] = check_attention_hd112(dev,
                                                                args.seed)
    scan_inputs_, scan_errs = check_scans(dev, args.seed)
    main_inputs.update(scan_inputs_)
    errs.update(scan_errs)

    phase("4. plan -> deploy -> serve")
    engine, reqs, launches = serve_main_path(dev, args.seed)
    launches_by_path, traces = {ARCH: launches}, {}
    for arch in RECURRENT:
        phase(f"4. serve {arch}")
        launches_by_path[arch], traces[arch] = serve_recurrent(
            arch, dev, args.seed)

    phase("5. full-width logits, kernels vs plain")
    compare_paths(dev, args.seed)
    for arch, (_, n_layers) in RECURRENT.items():
        compare_paths(dev, args.seed, arch, n_layers)

    phase("6. kernel times")
    rows = time_kernels(main_inputs, errs, launches_by_path)

    phase(f"7. device trace of one served {ARCH} batch")
    traces[ARCH] = trace_batch(engine, reqs)
    for arch, tr in traces.items():
        if tr:
            print(f"  {arch}: {100 * tr['busy']:.1f}% busy over a "
                  f"{tr['wall_ms']:.1f} ms batch, {tr['launches']} launches")

    phase("8. plan -> stress test on the card")
    t0 = time.perf_counter()
    risk = risk_stress_test()
    print(f"  phase 8 took {time.perf_counter() - t0:.1f}s")
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"risk": risk}))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
