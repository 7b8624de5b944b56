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
     (device programs, host syncs, launches, busy share, peak memory);
  9. plan on the card, replan in the loop: AGH on random_instance(200,
     160, 80, seed=42) (benchmarks/allocator_scaling.py's largest size)
     with the numpy engine and with the lane-batched torch tier on CUDA
     (a cold run, then a timed one): both objectives (numpy must be the
     reference's, the tier no worse than numpy's), walls, lanes and
     orderings, device calls, screen verdicts and the cost gate's
     verdict, peak device memory, and one phase-2 and one screen call
     replayed under torch.profiler (launches, copies, device time); then
     benchmarks/serve_closed_loop.py's forecast-mode day (random_instance
     (100, 80, 40, seed=42) under a 0.65 queueing margin, the "busy"
     diurnal day in 300 s windows, rate scale 0.005, seed 1) served once
     with a numpy PlanSession and once with PlanSession(engine="torch"),
     whose replans must be the numpy session's and no worse.

  10. MoE and io on the card, each model built, run and freed before the
     next: both attention kernels at the new configs' shapes (hd 128 at
     G 8, 5 and 6 with the MoE configs' 8192 window, musicgen's hd 64 at
     G 1) under phase 3's criteria, and the grouped int8 GEMM of the W8A8
     experts, both its kernels (the K-major wgmma one the port serves and
     the N-major mma.sync one, on the same values), bit for bit at
     kimi-k2's and llama4-scout's prefill and decode shapes, on the a of a
     served decode step (only the routed experts non-zero; how many it
     fills is printed) and on strided views, all timed as in phase 6 (the
     two kernels in turns, the K-major one's pre-pass alone, the dense
     bound and the bound on the filled experts' bytes, a loop of
     torch._int_mm per expert where its shape rules allow, a yardstick the
     port never calls); the served batch on four engines (kimi-k2 at 1
     layer, kimi-k2 W8A8 at 2, llama4-scout at 8 of 48, internvl2-26b
     whole), every kernel of each path launched (every W8A8 int8 launch on
     the wgmma kernel, its TTFT and tok/s printed beside the N-major
     kernel's from PERF.md), kimi-k2,
     its W8A8 engine (with the int8 kernels' device time) and
     llama4-scout traced with their launches per layer per decode step;
     musicgen-medium whole through `decoder.prefill` (a [8, 64, 1536]
     prefix, [8, 999, 4] codebook tokens) and 32 decode steps; phase 5's
     logits checks on llama4-scout (2 layers), internvl2-26b (4 layers,
     256-row prefix) and musicgen-medium (64-row prefix) in f32 and bf16,
     and kimi-k2 (1 layer) in bf16, where a miss is held to the routes the
     two paths took (`check_route_flips`).
  11. train on the card: the flash-attention forward's log-sum-exp and
     the backward kernel against their plain versions (f32 at 2e-5 of
     max|want|; bf16 per row at 2e-2, and within twice the plain bf16
     path's L2 distance to the exact f32 gradient; two launches bitwise
     equal) at qwen2-0.5b's training shape (B 8, H 14, KV 2, T 2048, hd
     64), a ragged T with Tq != Tk and window 256, hd 128 at G 8, a row
     with no admissible key, zamba2-7b's hd 112 (B 2, H 32, KV 32, T 1024,
     window 4096) and the smoke configs' hd 32 (B 4, H 4, KV 2, T 512);
     one full-width 2-layer train step, kernels vs
     plain (f32: loss 1e-5, every gradient leaf 1e-4 relative L2; bf16:
     each leaf within twice the plain path's distance to the f32 gradient
     plus 1e-3); qwen2-0.5b whole in bf16 trains 20 steps of
     PackedStream(151,936, 2048, 8) through the launcher's `train` (the
     loss must fall by 0.2; 48 flash and 24 backward launches a step),
     step ms, tokens/s, peak memory and one profiled step; its step-10
     checkpoint restored bit for bit and 3 steps from it against 3 from
     the live state; the backward's time at the training shape, hd 112
     and hd 32, each beside its bound, its plain version and SDPA's
     backward, and the forward with and without LSE.
  12. train the recurrent models: the backward kernels of both scans
     (ssm_scan_bwd, rwkv6_wkv_bwd), on the forward kernels' chunk states,
     against their plain versions (the stepwise formulas, in f32) at the
     training shape (B 8, T 2048, zero state, no final-state gradient;
     B is cut, and the cut printed, where the plain version's T + 1 states
     would not fit half the free memory), at T 999 from a nonzero state
     with a final-state gradient, at T 77 from zeros with one, and rwkv6
     also at the models' weak decay: f32 at 2e-5 of max|want|, bf16 under
     phase 11's criteria, two launches bitwise equal; a full-width train
     step, kernels vs plain, under phase 11.2's criteria at B 4 x T 999
     (a ragged last chunk) for rwkv6-7b at 2 layers and zamba2-7b at 7
     (one super-block of 6 Mamba2 layers, the shared attention at hd 112,
     one tail layer), and the backward kernels alone, the scan kernels'
     outputs set to the plain path's values, every f32 leaf at 1e-4 of
     the plain path (rwkv6's end-to-end f32 leaves are printed, not held:
     its group norm divides by rows' rms down to ~1e-3); both models in bf16 at phase 5's depths train 10
     steps of PackedStream(vocab, 2048, 8) through the launcher's `train`
     (the loss finite and falling; exact launch counts per step of every
     kernel of the path), step ms, tokens/s, peak memory and one profiled
     step; and each backward's time at the training shape beside its
     bound, its plain version, the forward with and without its chunk
     states and the time of its first, scalar kernel (copied from
     PERF.md, printed only), with a SASS line: the count of HMMA
     (tensor-core mma.sync) instructions in the backward's chunk kernel,
     which must be above 0.
  13. distribution: the planning CLI (`launch/plan.py --tiers tpu`) for
     agh and gh, every pair on a TPU tier and one unmet entry per query
     type; then, on a one-process NCCL group and a one-device ("data",
     "model") mesh, full-width qwen2-0.5b in bf16 made DTensors by
     `distribute_params` prefills the served batch's shape (B 8 x T 999)
     and decodes 32 steps with a DTensor cache, the attention kernels on
     local shards through `local_map`: the logits held against the
     unsharded kernel path under phase 5's bf16 criteria (the largest
     difference printed), flash and decode launched as often as there,
     both walls printed; the same with `seq_shard_attention`; and
     `pipelined_forward` over the 24 layers at one stage, 4 microbatches
     of B 2 x T 256, bit for bit the sequential run;
 14. the MoE, RWKV6 and Mamba2 mixers under a mesh, on the same
     one-device NCCL mesh: rwkv6-7b at 4 layers, zamba2-7b at 7, kimi-k2
     at 1 and kimi-k2 W8A8 at 2 (full width, bf16) prefill the served
     batch's shape and decode 32 steps on `distribute_params` trees that
     share the unsharded weights' storage, against the unsharded kernel
     path under phase 5's bf16 criteria (f32 truth for the recurrent two),
     every kernel launched as often as there and the N-major int8
     kernel never; each model's peak memory; one bf16 training step of
     rwkv6-7b and zamba2-7b at those depths (B 2 x T 512) on the mesh,
     every gradient leaf under phase 12's bf16 criterion, the scans and
     their backwards launched as often as unsharded; meanwhile, in two
     subprocesses on fake process groups (no card, started with phase 10,
     which with phases 11-14 keeps the card busy; each on a core of its own
     that this process keeps off meanwhile), `launch.dryrun` of
     qwen2-72b train_4k on 256 ranks and kimi-k2 decode_32k on 512, both
     `status: ok`, their rows and roofline lines printed; 14.5 the
     slot-split decode on the card at kimi-k2's per-rank decode_32k shape
     on 2x16x16 (B 4, KV 8, G 8, hd 128, bf16, an 8,192-slot ring cut
     into the 16 "model" ranks' 512 slots): the kernel with its
     log-sum-exp on each range, merged by `merge_decode_parts` (the
     mesh's arithmetic, over a stacked dim), against the kernel over the
     whole cache at the bf16 tolerances and its plain version in f32, at
     a late position (every range full) and an early one (14 ranges
     empty: zeros and -inf, no NaN); one range's call and the whole
     cache's (what each rank ran while the cache was gathered) timed as
     CUDA-graph replays beside their bytes bounds;
 15. the example drivers on the card, each as a subprocess with its
     default flags but the train twin's --steps 50:
     `examples/serve_e2e_torch.py` (AGH plans the default instance, the
     pairs deploy as smoke engines, 24 mixed requests are routed and
     served through the flash and decode kernels; its plan and pair
     lines must be those this process's planner gives) and
     `examples/train_demo_torch.py` (the ~100M f32 qwen2 config, 50
     AdamW steps through the flash kernel and its backward, a
     checkpoint; its loss must fall); each must exit 0 and launch its
     kernels, whose counts the twin sets to 0 before its run and prints
     after; tok/s, TTFT per type, the loss and both walls are printed;
     then `examples/quickstart_torch.py` (the planner surface; AGH on the
     lane-batched torch tier on the card, whose objective may only match
     or beat the numpy engine's printed beside it, with some phase-2
     device calls) and `examples/rolling_replay_torch.py --windows 16`
     (the numpy planner's rolling replay; both policies' rows printed);
 16. the configurations that had run only on the CPU, at published
     widths: 16.1 both attention kernels at the dense configs' served
     shapes (hd 128 at G 1, 6 and 8) under phase 3's criteria and timed
     as in phase 6; deepseek-7b whole (30 layers), qwen2-1.5b whole (28)
     and qwen2-72b at 16 of 80 layers, each built by the launcher's
     `build_engine` from --seed in bf16, serve phase 4's batch (launch
     counts exact, TTFT, tok/s, peak memory), one traced batch (phase 7)
     and phase 5's logits check at 2 layers; 16.2 the attention backward
     at the three families' step shapes under phase 11.1's criteria and
     timed as in phase 11.5, then llama4-scout-17b-a16e (1 layer, B 4 x T
     2048, its whole 202,048-word vocabulary: AdamW updates in place, see
     FAMILY_TRAIN), internvl2-26b (4 of 48 layers, B 4 x 256
     prefix rows + 1,792 tokens) and musicgen-medium (whole, B 8 x 64
     prefix rows + 999 codebook tokens, P + T 1,063): each a 2-layer
     full-width train step kernels vs plain under phase 11.2's criteria
     (llama4's four runs on the f32 kernel path's expert choices, the
     choices that differed printed), then, in a process of its own, 10
     bf16 AdamW steps through the launcher's `train` (the loss must
     fall; flash 2 and its backward 1 launch a layer a step; peak at most
     72 GiB and within 10 % of its reckoning), step ms, tokens/s and one
     profiled step.

Phases 8-16 print their numbers as JSON lines {"risk": ...},
{"allocator": ...}, {"closed_loop": ...}, {"moe_io": ...},
{"training": ...}, {"training_recurrent": ...}, {"distribution": ...},
{"mixers": ...}, {"examples": ...} and {"unseen_configs": ...}. The line
before the last is the kernel table as JSON; the last line is {"ok":
true, "device": {...}}. Without a CUDA device the run fails. To run phase
9, 10, 11, 12, 13, 14, 15 or 16 alone on a card: python -c "import
chip_smoke as cs; cs.plan_and_replan()" (or cs.moe_and_io(),
cs.train_and_check(), cs.train_recurrent(), cs.shard_and_pipeline(),
cs.mixers_under_a_mesh(), cs.run_examples(), cs.unseen_configs()).
"""
from __future__ import annotations

import argparse
import contextlib
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
# The served recurrent batches' TTFT ms and tok/s in PERF.md §5's table
# (the run after the scans' Hopper redesign, NVIDIA H100 80GB HBM3 at
# 700 W): printed beside this run's for reading only, never in a JSON line.
SERVED_AFTER_SCAN_REDESIGN = {
    "rwkv6-7b": ((389.61, 334.01, 334.05), (180.1, 203.9, 149.2)),
    "zamba2-7b": ((742.53, 728.28, 726.76), (66.5, 66.1, 63.1))}
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


def scan_inputs(kind, dtype, gen, dev, T=None, B=None, decay_shift=-1.5):
    """Inputs of a scan at the served batch's shape (B 8, T 999, or the
    B and T given), drawn as the reference's kernel sweep draws them
    (tests/test_kernels.py), and a nonzero initial state: ssm_scan at
    zamba2's widths (nh 112, hp 64, N 64), rwkv6_wkv at rwkv6-7b's (H 64,
    hd 64), its log decay -exp(N(0, 0.5) + decay_shift) (-6: the models'
    own weak decay, w0 = -6)."""
    B, T = B or len(PROMPT_LENS), T or max(PROMPT_LENS)

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
    lw = (-torch.exp(randn((B, T, H, hd), 0.5) + decay_shift)).to(dtype)
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
    from repro_torch.kernels.flash_attention_bwd.ops import \
        flash_attention_bwd
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul
    from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
    from repro_torch.kernels.rwkv6_wkv_bwd.ops import rwkv6_wkv_bwd
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    from repro_torch.kernels.ssm_scan_bwd.ops import ssm_scan_bwd
    return {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention,
            "ssm_scan": ssm_scan, "ssm_scan_bwd": ssm_scan_bwd,
            "rwkv6_wkv": rwkv6_wkv, "rwkv6_wkv_bwd": rwkv6_wkv_bwd,
            "int8_grouped_matmul": int8_grouped_matmul}


def serve_counted(engine, reqs, kernels, label, seed):
    """Serve `reqs` once with every launch count set to 0 just before and
    read just after, then twice more for the spread of the host-clock
    numbers. Fails unless each of `kernels` launched and every request
    got its tokens. Returns the counts."""
    from repro_torch.launch import serve

    cfg = engine.cfg
    ops = kernel_ops()
    int8 = ops["int8_grouped_matmul"]
    for op in ops.values():
        op.launches = 0
    int8.wgmma_launches = 0
    stats = serve.serve_batch(engine, reqs)
    launches = {name: op.launches for name, op in ops.items()}
    launches[INT8_WGMMA] = int8.wgmma_launches
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
    if label in SERVED_AFTER_SCAN_REDESIGN:
        ttft, tps = SERVED_AFTER_SCAN_REDESIGN[label]
        print(f"  after the scans' redesign (from PERF.md §5): TTFT ms "
              f"{list(ttft)}, tok/s {list(tps)}", flush=True)
    for r in reqs:
        if len(r.output) != NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            fail(f"request {r.rid} got {len(r.output)} tokens {r.output}")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"the served {label} batch never launched {name}")
    return launches, runs


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
    launches, _ = serve_counted(engine, reqs,
                                ("flash_attention", "decode_attention"),
                                ARCH, seed)
    return engine, reqs, launches


def serve_recurrent(arch, dev, seed):
    """Phase 4 for a recurrent model, full width and depth: see
    `serve_and_trace`. Returns the launch counts and the trace's
    summary."""
    from repro_torch.configs import get_config

    out = serve_and_trace(get_config(arch), arch, RECURRENT[arch][0], dev,
                          seed, "7.")
    return out["launches"], out["trace"]


def serve_and_trace(cfg, label, kernels, dev, seed, tag) -> dict:
    """Phase 4 for one more model: a bf16 engine of `cfg` (the launcher's
    `build_engine`, random weights from `seed`) serves the batch
    (`serve_counted`: each of `kernels` must launch), then phase 7 (`tag`
    names the phase printed) traces one more batch, before the engine is
    freed for the next. Returns the parameter count, the launch counts,
    the three runs, the peak GiB allocated since the engine was built,
    and the trace's summary."""
    import gc

    from repro_torch.launch import serve

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    T = max(PROMPT_LENS)
    t0 = time.perf_counter()
    engine = serve.build_engine(cfg, dev, seed, max_len=T + NEW_TOKENS,
                                max_batch=len(PROMPT_LENS))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(engine.params))
    print(f"  {label}: {cfg.n_layers} layers, d_model {cfg.d_model}, H "
          f"{cfg.n_heads}, KV {cfg.n_kv_heads}, hd {cfg.hd}, "
          f"{n_par / 1e9:.2f} B parameters drawn in "
          f"{time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated",
          flush=True)
    serve.serve_batch(engine, serve.make_requests([16, 9], 2,
                                                  cfg.vocab_size, seed + 1))
    reqs = serve.make_requests(PROMPT_LENS, NEW_TOKENS, cfg.vocab_size, seed)
    launches, runs = serve_counted(engine, reqs, kernels, label, seed)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  peak {peak:.2f} GiB allocated since the engine was built",
          flush=True)
    phase(f"{tag} device trace of one served {label} batch")
    trace = trace_batch(engine, reqs)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params=n_par, launches=launches, runs=runs, peak_gib=peak,
                trace=trace)


@dataclasses.dataclass
class DeviceRow:
    """One kernel (or copy) name's device time as `key_averages()` gives
    it: launches and their total µs."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0


def device_rows(prof) -> list:
    """The device events (kernels, copies, sets) a finished
    torch.profiler run saw, summed by name, as the CUDA rows of
    `prof.key_averages()` with device time. Read from the profiler's raw
    results: `key_averages()` first parses every host event too, ~35 s
    for a served batch's ~3e5 events on the H100's host, for the same
    device rows. A torch without those raw results fails the run, so the
    yardstick of busy ms and launches never changes unseen."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        fail("torch.profiler has no kineto_results to read device rows "
             f"from (torch {torch.__version__})")
    rows: dict = {}
    for e in raw.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                e.duration_ns() > 0:
            row = rows.setdefault(e.name(), DeviceRow(e.name()))
            row.count += 1
            row.self_device_time_total += e.duration_ns() / 1e3
    return list(rows.values())


def trace_batch(engine, reqs, named=None):
    """Phase 7: the served batch again, under torch.profiler. Returns
    (busy share, wall ms, busy ms, launches), or None when the profiler
    saw no CUDA kernel. `named` {label: substrings} adds, under "named",
    each label's device ms and launches over the kernels whose name holds
    one of its substrings."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve

    fresh = [dataclasses.replace(r, output=[], first_token_s=None,
                                 done_s=None) for r in reqs]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = serve.serve_batch(engine, fresh)
    rows = device_rows(prof)
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
    out = dict(busy=busy_ms / wall_ms, wall_ms=wall_ms, busy_ms=busy_ms,
               launches=n)
    if named:
        out["named"] = {}
        for label, subs in named.items():
            hit = [e for e in rows if any(x in e.key for x in subs)]
            out["named"][label] = dict(
                device_ms=sum(e.self_device_time_total for e in hit) / 1e3,
                launches=sum(e.count for e in hit))
            print(f"  {label}: {out['named'][label]['device_ms']:.3f} ms of "
                  f"device time in {out['named'][label]['launches']} "
                  f"launches", flush=True)
    return out


def compare_paths(dev, seed, arch=ARCH, n_layers=None, prefix_rows=0,
                  with_f32=True):
    """Phase 5: full-width prefill + 4 decode steps, kernels vs plain, in
    f32 and in bf16 on the same bf16-rounded weights; `n_layers` cuts the
    depth, `prefix_rows` puts that many prefix embeddings before the
    tokens (codebook configs get [B, T, nq] tokens). Without `with_f32`
    (a model whose f32 weights do not fit) only the bf16 bound is held.
    On an MoE model a failed bf16 bound is explained or not by the routes
    the two paths took (`check_route_flips`)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import decoder

    cfg16 = get_config(arch)
    if n_layers:
        cfg16 = dataclasses.replace(cfg16, n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    params16 = decoder.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg16)
    B, T, n_dec = 2, max(PROMPT_LENS), 4
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    nq = (cfg16.n_codebooks,) if cfg16.n_codebooks else ()
    toks = torch.randint(1, cfg16.vocab_size, (B, T + n_dec, *nq),
                         generator=gen, device=dev)
    prefix = (torch.randn((B, prefix_rows, cfg16.d_model), generator=gen,
                          device=dev) if prefix_rows else None)
    name = (f"{cfg16.name} ({cfg16.n_layers} layer"
            + ("s" if cfg16.n_layers > 1 else "")
            + (f", {prefix_rows}-row prefix" if prefix_rows else "")
            + (f", {nq[0]} codebooks" if nq else "") + ")")

    def run(params, cfg, use_kernels, routes=None, cfg_decode=None):
        with same_routes(routes, []), torch.inference_mode():
            lg, cache = decoder.prefill(params, cfg, toks[:, :T], prefix,
                                        max_len=prefix_rows + T + n_dec,
                                        use_kernels=use_kernels)
            out = [lg]
            for t in range(T, T + n_dec):
                lg, cache = decoder.decode_step(
                    params, cfg_decode or cfg, cache, toks[:, t:t + 1],
                    prefix_rows + t, use_kernels=use_kernels)
                out.append(lg)
        got = torch.cat(out, dim=1)
        if not torch.isfinite(got).all():
            fail(f"non-finite {cfg.dtype} logits of {name} "
                 f"(kernels={use_kernels})")
        return got.float()

    want = None
    if with_f32:
        params32 = _tree_map(lambda x: x.float(), params16)
        got, want = run(params32, cfg32, True), run(params32, cfg32, False)
        del params32
        print(f"  {name} logits scale: max |plain| = "
              f"{want.abs().max().item():.3f}")
        check_close(f"f32 {name} prefill T={T} + {n_dec} decode steps, "
                    f"kernels vs plain", got, want, E2E_TOL)
    routes_k, routes_p = [], []
    got16 = run(params16, cfg16, True, routes_k)
    want16 = run(params16, cfg16, False, routes_p)
    rel = row_rel(got16, want16)
    same = (got16.argmax(-1) == want16.argmax(-1)).float().mean().item()
    if want is not None:
        rel_k, rel_p = row_rel(got16, want), row_rel(want16, want)
        ok = rel <= E2E_BF16_REL and rel_k <= 2 * rel_p + E2E_TOL
        vs_f32 = (f"; vs the f32 logits: kernels {rel_k:.3e}, plain "
                  f"{rel_p:.3e} (tol 2x plain + {E2E_TOL:g})")
    else:
        ok, vs_f32 = rel <= E2E_BF16_REL, " (no f32 run: its weights do " \
                                          "not fit)"
    print(f"  bf16 {name} prefill T={T} + {n_dec} decode steps: "
          f"max_row_rel_err kernels vs plain {rel:.3e} (tol "
          f"{E2E_BF16_REL:g}){vs_f32}; same greedy token in {same:.3f} of "
          f"rows {'ok' if ok else 'MISMATCH'}", flush=True)
    flips = None
    if not ok and cfg16.n_experts:
        flips = check_route_flips(run, params16, cfg16, name, routes_k,
                                  routes_p, B, T)
    elif not ok:
        fail(f"bf16 logits of {name}'s kernel path disagree with the "
             f"plain path")
    del params16
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": name, "bf16_max_row_rel_err": rel,
            "f32_checked": want is not None, "route_flips": flips}


def check_route_flips(run, params, cfg, name, routes_k, routes_p, B, T):
    """A failed bf16 bound on an MoE model: the two paths' attention
    differs by bf16 rounding, which can move a token across a tie in its
    router and send it to another expert, far from the other path's row
    with no fault in any kernel. Shows the routes that differ, then runs
    both paths again with a capacity that drops nothing (C = N: a token
    sends at most one copy to an expert), so that one flip cannot cascade
    into drops, and holds the logit rows whose own routes agree in every
    layer to the bound. Fails when no route differs, or when an agreeing
    row misses the bound."""
    L = cfg.n_layers
    differ = [int((~same_choices(a, b)).sum())
              for a, b in zip(routes_k, routes_p)]
    print(f"  {name}: tokens routed differently by the two paths, per MoE "
          f"call (prefill's {L} layers, then {L} per decode step): "
          f"{differ}", flush=True)
    if not any(differ):
        fail(f"bf16 logits of {name}'s kernel path disagree with the plain "
             f"path, and no route differs")
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    routes_k, routes_p = [], []
    got = run(params, no_drop, True, routes_k)
    want = run(params, no_drop, False, routes_p)
    n_steps = got.shape[1]
    agree = torch.ones(B, n_steps, dtype=torch.bool, device=got.device)
    for call, (a, b) in enumerate(zip(routes_k, routes_p)):
        same = same_choices(a, b)
        step = call // L
        if step == 0:          # prefill: the row of each sequence's last token
            same = same.view(B, T)[:, -1]
        agree[:, step] &= same
    rows = int(agree.sum())
    if rows == 0:
        fail(f"{name}: no logit row has the same routes on both paths")
    rel = row_rel(got[agree], want[agree])
    print(f"  {name}, capacity factor {no_drop.capacity_factor:g} (no "
          f"drops): {rows} of {agree.numel()} logit rows route alike on "
          f"both paths; their max_row_rel_err kernels vs plain {rel:.3e} "
          f"(tol {E2E_BF16_REL:g}) {'ok' if rel <= E2E_BF16_REL else 'MISMATCH'}",
          flush=True)
    if rel > E2E_BF16_REL:
        fail(f"bf16 logits of {name} disagree on rows whose routes agree")
    return {"tokens_routed_differently": differ, "rows_agreeing": rows,
            "rows": agree.numel(), "agreeing_max_row_rel_err": rel}


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
    rows = device_rows(prof)
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


# Phase 9: AGH at benchmarks/allocator_scaling.py's largest size on both
# engines, then benchmarks/serve_closed_loop.py's forecast-mode day with
# every replan on the card. The reference's objectives and replan count on
# the same instances (numpy and xla alike, seeded, so the port's numpy
# engine must give the same) are recorded in CHANGES.md.
TIER_SIZE, TIER_SEED = (200, 160, 80), 42
TIER_REF_OBJECTIVE = 849.8622
LOOP_SIZE, LOOP_SEED = (100, 80, 40), 42
LOOP_RHO_MAX = 0.65
LOOP_TRAFFIC = dict(horizon_s=86400.0, window_s=300.0, rate_scale=0.005,
                    trace="busy", seed=1)
LOOP_FORECAST = dict(drift_threshold=0.5, cooldown=6, ewma_alpha=0.5)
LOOP_REF_COLD_OBJECTIVE = 768.1072
LOOP_REF_REPLANS = 14
TIER_RTOL = 1e-6        # the tier may only match or beat numpy


def _recording_tier(record: dict):
    """Wrap the tier's two programs for one solve: keep the first phase-2
    call's inputs and the widest screen call's, and add up the host time
    inside the phase-2 calls (the screen's is the solve's `screen_s`).
    Returns the undo function."""
    from repro_torch.core import tier_kernels as tk

    p2, sc = tk.phase2_keys, tk.screen_sources
    record.update(phase2_s=0.0, phase2_args=None, screen_args=None)

    def phase2_keys(tx, items, counters=None):
        if record["phase2_args"] is None:
            record["phase2_args"] = (tx, [tuple(a.copy() if isinstance(
                a, np.ndarray) else a for a in it) for it in items])
        t0 = time.perf_counter()
        try:
            return p2(tx, items, counters)
        finally:
            record["phase2_s"] += time.perf_counter() - t0

    def screen_sources(tx, groups, srcs, load, counters=None):
        widest = record["screen_args"]
        if widest is None or len(srcs) > len(widest[2]):
            record["screen_args"] = (tx, list(groups), list(srcs),
                                     load.copy())
        return sc(tx, groups, srcs, load, counters)

    tk.phase2_keys, tk.screen_sources = phase2_keys, screen_sources

    def undo():
        tk.phase2_keys, tk.screen_sources = p2, sc
    return undo


def _per_call(name, fn, n: int = 10) -> dict:
    """One program call, replayed `n` times on its recorded inputs after a
    warm-up: its host wall per call (each replay synchronized) and, from
    torch.profiler over `n` more replays (device activity only, as phase
    8 traces), the kernels it launches, the copies it makes and its
    device time, per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    copies = sum(e.count for e in rows
                 if e.key.startswith(("Memcpy", "Memset")))
    out = {"wall_ms": wall_ms,
           "launches": (sum(e.count for e in rows) - copies) / n
           if rows else None,
           "copies": copies / n if rows else None,
           "device_ms": (sum(e.self_device_time_total for e in rows)
                         / 1e3 / n if rows else None)}
    print(f"  one {name} call (mean of {n}): {wall_ms:.3f} ms host wall, "
          f"{out['launches']} kernel launches, {out['copies']} copies, "
          f"{out['device_ms']} ms device time")
    return out


def allocator_tier() -> dict:
    """Phase 9a: AGH at (200,160,80) on numpy and on the torch tier (the
    card). Returns the phase's numbers."""
    from repro_torch.core import random_instance
    from repro_torch.core import tier_kernels as tk
    from repro_torch.planner import PlanOptions, plan

    inst = random_instance(*TIER_SIZE, seed=TIER_SEED)
    out = {"size": list(TIER_SIZE), "seed": TIER_SEED,
           "ref_objective": TIER_REF_OBJECTIVE}
    t0 = time.perf_counter()
    res_np = plan("agh", instance=inst, options=PlanOptions(workers=0))
    out["numpy_wall_s"] = time.perf_counter() - t0
    out["numpy_objective"] = res_np.objective
    print(f"  numpy AGH on {TIER_SIZE}: objective {res_np.objective:.4f} "
          f"(the reference's: {TIER_REF_OBJECTIVE}), "
          f"{out['numpy_wall_s']:.3f} s, "
          f"{res_np.diagnostics['orderings_evaluated']} orderings",
          flush=True)
    if abs(res_np.objective - TIER_REF_OBJECTIVE) > 1e-4:
        fail(f"numpy AGH objective {res_np.objective} is not the "
             f"reference's {TIER_REF_OBJECTIVE}")

    opts = PlanOptions(engine="torch", workers=0)
    t0 = time.perf_counter()
    first = plan("agh", instance=inst, options=opts)
    torch.cuda.synchronize()
    out["torch_first_wall_s"] = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    record = {}
    undo = _recording_tier(record)
    try:
        t0 = time.perf_counter()
        res = plan("agh", instance=inst, options=opts)
        torch.cuda.synchronize()
        out["torch_wall_s"] = time.perf_counter() - t0
    finally:
        undo()
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    out["resident_gib"] = held / 2 ** 30
    d = res.diagnostics
    if d.get("engine") != "torch":
        fail(f"plan(engine='torch') ran {d.get('engine')!r}")
    if not (np.isfinite(res.objective) and res.feasible):
        fail(f"torch tier plan: objective {res.objective}, feasible "
             f"{res.feasible}")
    if res.objective != first.objective:
        fail(f"two torch tier solves differ: {first.objective} vs "
             f"{res.objective}")
    if res.objective > res_np.objective * (1 + TIER_RTOL):
        fail(f"torch tier objective {res.objective} is above numpy's "
             f"{res_np.objective}")
    out["torch_objective"] = res.objective
    keys = ("restarts", "orderings_evaluated", "early_stopped",
            "device_calls_phase2", "device_calls_screen", "screen_sources",
            "screened_clean", "screen_bypassed", "scans", "scan_s",
            "screen_s", "moves_applied", "rescans")
    out["stats"] = {k: d.get(k, 0) for k in keys}
    out["phase2_s"] = record["phase2_s"]
    # Lanes: the random restarts plus the deterministic orderings (and a
    # warm lane, when there is one), all in the first lockstep call.
    out["lanes"] = (len(record["phase2_args"][1])
                    if record["phase2_args"] is not None else 0)
    n_req = out["stats"]["screen_sources"] + out["stats"]["screen_bypassed"]
    out["screen_kept_share"] = (out["stats"]["screen_sources"] / n_req
                                if n_req else None)
    out["gate"] = ("on" if not out["stats"]["screen_bypassed"] else
                   "off after warm-up" if not n_req or
                   out["stats"]["screen_bypassed"] / n_req > 0.5 else
                   "partly off")
    print(f"  torch tier on the card: objective {res.objective:.4f}; "
          f"first (cold) run {out['torch_first_wall_s']:.3f} s, timed run "
          f"{out['torch_wall_s']:.3f} s (numpy {out['numpy_wall_s']:.3f} "
          f"s); {out['lanes']} lanes ({out['stats']['restarts']} random), "
          f"{out['stats']['orderings_evaluated']} orderings evaluated",
          flush=True)
    print(f"  device calls: phase-2 {out['stats']['device_calls_phase2']} "
          f"({out['phase2_s']:.3f} s), screen "
          f"{out['stats']['device_calls_screen']} "
          f"({out['stats']['screen_s']} s) over "
          f"{out['stats']['screen_sources']} sources; screened clean "
          f"{out['stats']['screened_clean']}, bypassed by the gate "
          f"{out['stats']['screen_bypassed']}; host scans "
          f"{out['stats']['scans']} ({out['stats']['scan_s']} s); gate: "
          f"{out['gate']}; peak device memory {out['peak_mem_gib']:.3f} "
          f"GiB above {out['resident_gib']:.3f} GiB held", flush=True)
    if record["phase2_args"] is not None:
        tx, items = record["phase2_args"]
        out["phase2_call"] = _per_call(
            f"phase-2 ({len(items)} lanes)",
            lambda: tk.phase2_keys(tx, items))
    if record["screen_args"] is not None:
        tx, groups, srcs, load = record["screen_args"]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out["screen_call"] = _per_call(
            f"screen ({len(srcs)} sources, {len(groups)} groups)",
            lambda: tk.screen_sources(tx, groups, srcs, load))
        out["screen_call"]["peak_mem_gib"] = (
            (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        print(f"  the widest screen call's peak device memory: "
              f"{out['screen_call']['peak_mem_gib']:.3f} GiB")
    return out


def closed_loop_day(engine: str) -> dict:
    """Phase 9b: one serve() of the forecast-mode day, every replan on
    `engine`. Returns the day's numbers."""
    from repro_torch.core import random_instance
    from repro_torch.core.queueing import with_queueing_margin
    from repro_torch.planner import PlanOptions, PlanSession
    from repro_torch.serving import ControllerSpec, TrafficSpec, serve

    inst = random_instance(*LOOP_SIZE, seed=LOOP_SEED)
    sess = PlanSession(engine=engine, options=PlanOptions(workers=0))
    t0 = time.perf_counter()
    res = sess.plan(instance=with_queueing_margin(inst, LOOP_RHO_MAX))
    plan_s = time.perf_counter() - t0
    sr = serve(res, instance=inst, session=sess,
               traffic=TrafficSpec(**LOOP_TRAFFIC),
               controller=ControllerSpec(mode="forecast",
                                         rho_max=LOOP_RHO_MAX,
                                         **LOOP_FORECAST))
    wall = time.perf_counter() - t0
    p99 = float(np.nanmax(sr.per_type_e2e_p99 / inst.Delta))
    out = {"engine": res.diagnostics.get("engine", engine),
           "cold_objective": res.objective, "cold_plan_s": plan_s,
           "replans": [[e.window, e.cause, e.objective, e.wall_s]
                       for e in sr.replans],
           "attainment": sr.attainment(), "p99_over_slo": p99,
           "served": sr.n_served, "shed": sr.n_shed,
           "planner_wall_s": plan_s + sr.planner_wall_s,
           "planner_share": (plan_s + sr.planner_wall_s)
           / LOOP_TRAFFIC["horizon_s"], "wall_s": wall}
    if not (np.isfinite(res.objective) and sr.n_served > 0
            and len(sr.per_type_e2e_p99) == inst.I):
        fail(f"closed loop on {engine}: objective {res.objective}, served "
             f"{sr.n_served}")
    print(f"  {engine} session: cold objective {res.objective:.4f} "
          f"({plan_s:.3f} s); {len(sr.replans)} replans "
          f"{[(e.window, e.cause) for e in sr.replans]}; attainment "
          f"{out['attainment']:.6f}, worst-type p99 / SLO {p99:.4f}, "
          f"served {sr.n_served}, shed {sr.n_shed}; planner wall "
          f"{out['planner_wall_s']:.3f} s = "
          f"{100 * out['planner_share']:.4f} % of the horizon; day "
          f"{wall:.1f} s", flush=True)
    return out


def plan_and_replan() -> dict:
    """Phase 9: plan on the card, replan in the loop."""
    out = {"allocator": allocator_tier()}
    loop = {"numpy": closed_loop_day("numpy")}
    loop["torch"] = closed_loop_day("torch")
    np_day, t_day = loop["numpy"], loop["torch"]
    if abs(np_day["cold_objective"] - LOOP_REF_COLD_OBJECTIVE) > 1e-4:
        fail(f"numpy cold objective {np_day['cold_objective']} is not the "
             f"reference's {LOOP_REF_COLD_OBJECTIVE}")
    if t_day["engine"] != "torch":
        fail(f"the torch session ran {t_day['engine']!r}")
    causes = lambda day: [(w, c) for w, c, _, _ in day["replans"]]
    if causes(t_day) != causes(np_day):
        fail(f"torch session replans {causes(t_day)} differ from numpy's "
             f"{causes(np_day)}")
    for (_, _, o_t, _), (_, _, o_n, _) in zip(t_day["replans"],
                                              np_day["replans"]):
        if o_t > o_n * (1 + TIER_RTOL):
            fail(f"a torch replan's objective {o_t} is above numpy's {o_n}")
    if (t_day["cold_objective"] > np_day["cold_objective"] * (1 + TIER_RTOL)
            or t_day["attainment"] < np_day["attainment"] - 1e-9):
        fail(f"torch session worse than numpy's: {t_day} vs {np_day}")
    print(f"  replans: {len(np_day['replans'])} on both (the reference's "
          f"day: {LOOP_REF_REPLANS})")
    out["closed_loop"] = loop
    return out

# Phase 10: the MoE and io configs at full width. The served engines:
# (label, arch, config fields replaced, kernels the path must launch, traced
# in phase 7). Every width, expert and top-k is the published one; only
# depth is cut, to fit one 80 GB card in bf16 (PERF.md §4).
MOE_IO_ENGINES = (
    ("kimi-k2 (1 layer)", "kimi-k2-1t-a32b", dict(n_layers=1),
     ("flash_attention", "decode_attention"), True),
    ("kimi-k2 W8A8 (2 layers)", "kimi-k2-1t-a32b",
     dict(n_layers=2, moe_w8a8=True),
     ("flash_attention", "decode_attention", "int8_grouped_matmul",
      "int8_grouped_matmul_wgmma"), True),
    ("llama4-scout (8 of 48 layers)", "llama4-scout-17b-a16e",
     dict(n_layers=8), ("flash_attention", "decode_attention"), True),
    ("internvl2-26b", "internvl2-26b", {},
     ("flash_attention", "decode_attention"), False),
)
MUSICGEN = "musicgen-medium"
# Phase 5 for them: (arch, layers, prefix rows, f32 check too). kimi-k2's f32
# weights alone take 77 GB, so it is held in bf16 only.
MOE_IO_LOGITS = (("llama4-scout-17b-a16e", 2, 0, True),
                 ("internvl2-26b", 4, 256, True),
                 (MUSICGEN, None, 64, True),
                 ("kimi-k2-1t-a32b", 1, 0, False))
# Attention at the new configs' served shapes: (label, arch, tokens before
# the prompt). hd 128 at G 8, 5, 6 (window 8192 on the MoE configs), and
# musicgen's hd 64 at G 1 after its 64-row prefix.
MOE_IO_ATTENTION = (("kimi-k2", "kimi-k2-1t-a32b", 0),
                    ("llama4-scout", "llama4-scout-17b-a16e", 0),
                    ("internvl2-26b", "internvl2-26b", 0),
                    ("musicgen-medium", MUSICGEN, 64))
PEAK_INT8_OPS = 1979e12     # H100 SXM data sheet, dense int8 tensor cores


def _int8_shapes():
    """The grouped int8 GEMM at the served W8A8 shapes: kimi-k2's three
    products (w1 and w3 share a shape) and llama4-scout's w1, at the
    prefill's capacity (8 prompts padded to 999 tokens) and a decode
    step's (1 slot per expert). (label, arch, E, C, K, N)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity

    out = []
    N_pre, N_dec = len(PROMPT_LENS) * max(PROMPT_LENS), len(PROMPT_LENS)
    for arch, prods in (("kimi-k2-1t-a32b", ("w1", "w2")),
                        ("llama4-scout-17b-a16e", ("w1",))):
        cfg = get_config(arch)
        for step, n in (("prefill", N_pre), ("decode", N_dec)):
            for w in prods:
                K, N = ((cfg.d_model, cfg.d_ff) if w == "w1"
                        else (cfg.d_ff, cfg.d_model))
                out.append((f"{arch} {step} {w}", arch, cfg.n_experts,
                            capacity(cfg, n), K, N))
    return out


def routed_a(gen, arch, C, K, dev):
    """The a [E, C, K] of a served decode step of len(PROMPT_LENS) tokens:
    each token's top-k experts by random router scores (a stable sort, as
    the port routes), its copy ranked within its expert in token order by
    the port's own `dispatch_slots` and dropped past C, random int8 in the
    rows that hold a copy and zeros elsewhere, as the MoE layer's zero-
    filled buffer gives. Returns (a, experts filled)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import dispatch_slots

    cfg = get_config(arch)
    E, n = cfg.n_experts, len(PROMPT_LENS)
    scores = torch.rand((n, E), generator=gen, device=dev)
    idx = torch.sort(scores, dim=-1, descending=True,
                     stable=True)[1][:, :cfg.top_k]
    slot, keep = dispatch_slots(idx, C)
    a = torch.zeros((E, C, K), dtype=torch.int8, device=dev)
    e, r = idx.reshape(-1)[keep], slot[keep]
    a[e, r] = torch.randint(-128, 128, (int(keep.sum()), K), generator=gen,
                            device=dev, dtype=torch.int8)
    return a, int(a.ne(0).flatten(1).any(1).sum())


def int8_bounds(E, C, K, N, filled=None):
    """(ms, by) of out = a @ b at [E,C,K] x [E,K,N]: a read once, the int32
    output written once, and b of the `filled` experts (every expert
    when None) read once, against 2 filled C K N operations at 1,979 TOP/s
    int8."""
    f = E if filled is None else filled
    return bound(E * C * K + f * K * N + 4 * E * C * N, 2.0 * f * C * K * N,
                 PEAK_INT8_OPS)


def check_and_time_int8(dev, seed, bf16_bmm=False):
    """Phase 3 and 6 for the grouped int8 GEMM: both kernels, the K-major
    wgmma one (the served path: the port stores the expert weights
    K-major) and the N-major mma.sync one, bit for bit against the plain
    version (f64 products, exact) on strided views and at every served
    shape, dense (random a: every expert filled) and, at the decode
    shapes, routed (the a of a served decode step: only the experts its
    tokens chose are non-zero). Then each kernel's time at each shape,
    the two in turns (K, N, N, K), beside the dense bound (bytes of a,
    b and the int32 output at 3.35 TB/s against 2 E C K N operations at
    1,979 TOP/s int8) and at a routed shape the bound on the filled
    experts' bytes; the plain version's time; the K-major kernel's
    pre-pass alone (which token tiles hold a token, the work list); where
    torch._int_mm's shape rules allow (more than 16 rows), a loop of one
    _int_mm per expert (a yardstick the port never calls; not one
    PyTorch call, so it stays out of `library_ms`); with `bf16_bmm`, the
    same product by bf16 `torch.bmm` (the bf16 experts' product)."""
    from repro_torch.kernels.int8_grouped_matmul import kernel as gk
    from repro_torch.kernels.int8_grouped_matmul.ref import \
        int8_grouped_matmul_ref
    from repro_torch.models.moe import kmajor

    gen = torch.Generator(device=dev).manual_seed(seed + 10)

    def rand(shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def check(label, a, b):
        want = int8_grouped_matmul_ref(a, b)
        errs = []
        for name, bb in (("K-major", kmajor(b)), ("N-major", b)):
            got = gk.int8_grouped_matmul(a, bb)
            errs.append((got.long() - want.long()).abs().max().item())
            print(f"  int8_grouped_matmul {name} {label}: max_abs_err "
                  f"{errs[-1]} {'ok' if errs[-1] == 0 else 'MISMATCH'}",
                  flush=True)
            if errs[-1] != 0 or got.dtype != torch.int32:
                fail(f"int8_grouped_matmul ({name}) disagrees with its "
                     f"plain version at {label}")
        return max(errs)

    # Strided views: a window of a wider buffer with the expert axis not
    # outermost; b's columns cut from a wider matrix, and (K-major) a
    # window of a wider K-major storage.
    a = rand((217, 16, 5120 + 64))[5:5 + 208, :, 32:32 + 5120].transpose(0, 1)
    b = rand((16, 5120, 2048 + 128))[:, :, 64:64 + 2048]
    worst = check(f"on strided views a {tuple(a.shape)} strides "
                  f"{a.stride()}, b {tuple(b.shape)} strides {b.stride()}",
                  a, b)
    bk = rand((16, 2048 + 48, 5120 + 96))[:, 16:16 + 2048,
                                          32:32 + 5120].transpose(1, 2)
    same = torch.equal(gk.int8_grouped_matmul(a, bk),
                       int8_grouped_matmul_ref(a, bk))
    print(f"  int8_grouped_matmul K-major on a window of a K-major storage "
          f"(strides {bk.stride()}): {'bit for bit' if same else 'MISMATCH'}",
          flush=True)
    if not same:
        fail("int8_grouped_matmul disagrees with its plain version on a "
             "window of a K-major b")
    del a, b, bk
    timed = {}
    for label, arch, E, C, K, N in _int8_shapes():
        b = rand((E, K, N))
        cases = [("", rand((E, C, K)), None)]
        if C == 1:
            a_r, filled = routed_a(gen, arch, C, K, dev)
            print(f"  {label}: a served decode step of {len(PROMPT_LENS)} "
                  f"tokens fills {filled} of {E} experts", flush=True)
            cases.append((" routed", a_r, filled))
        b_k = kmajor(b)
        for tag, a, filled in cases:
            key = label + tag
            err = max(worst, check(f"{key} [{E},{C},{K}] x [{E},{K},{N}]",
                                   a, b))
            ms_k, eager_k = time_ms([lambda: gk.int8_grouped_matmul(a, b_k)],
                                    n=20)
            ms_n, _ = time_ms([lambda: gk.int8_grouped_matmul(a, b)], n=20)
            ms_n2, _ = time_ms([lambda: gk.int8_grouped_matmul(a, b)], n=20)
            ms_k2, _ = time_ms([lambda: gk.int8_grouped_matmul(a, b_k)],
                               n=20)
            pre_ms, _ = time_ms([lambda: gk.prepass(a, b_k)], n=20)
            plain_ms = _event_ms(lambda: int8_grouped_matmul_ref(a, b_k), 2)
            loop_ms = (_event_ms(lambda: [torch._int_mm(a[e], b[e])
                                          for e in range(E)], 3)
                       if C > 16 else None)
            bnd, by = int8_bounds(E, C, K, N)
            t = dict(ms=(ms_k + ms_k2) / 2, ms_turns=[ms_k, ms_k2],
                     eager_ms=eager_k, nmajor_ms=(ms_n + ms_n2) / 2,
                     nmajor_ms_turns=[ms_n, ms_n2], prepass_ms=pre_ms,
                     plain_ms=plain_ms, max_abs_err=err, bound_ms=bnd,
                     bound_by=by, int_mm_loop_ms=loop_ms,
                     token_tile=gk.plan(E, C, K, N).token_tile,
                     shape=f"[{E},{C},{K}] x [{E},{K},{N}]")
            if filled is not None:
                t["filled_experts"] = filled
                t["routed_bound_ms"], t["routed_bound_by"] = int8_bounds(
                    E, C, K, N, filled)
            if bf16_bmm:
                a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
                t["bf16_bmm_ms"] = _event_ms(lambda: torch.bmm(a16, b16), 5)
                del a16, b16
            timed[key] = t
            share = (f", {100 * t['routed_bound_ms'] / t['ms']:.1f} % of the "
                     f"routed bound {t['routed_bound_ms']:.4f} ms "
                     f"({t['routed_bound_by']})" if filled is not None
                     else "")
            print(f"    K-major (wgmma) {ms_k:.4f} / {ms_k2:.4f} ms (eager "
                  f"{eager_k:.4f}; pre-pass {pre_ms:.4f}), N-major (mma.sync) "
                  f"{ms_n:.4f} / {ms_n2:.4f} ms; dense bound {bnd:.4f} ms "
                  f"({by}), {100 * bnd / t['ms']:.1f} % of it{share}; plain "
                  f"{plain_ms:.1f} ms, _int_mm loop "
                  + ("n/a (C <= 16)" if loop_ms is None
                     else f"{loop_ms:.3f} ms")
                  + (f", bf16 bmm {t['bf16_bmm_ms']:.4f} ms" if bf16_bmm
                     else ""), flush=True)
        del a, b, b_k, cases
        torch.cuda.empty_cache()
    return timed


def _event_ms(fn, n: int) -> float:
    """Mean device-clock ms of n eager calls of fn after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def check_and_time_attention_moe_io(dev, seed, cases=MOE_IO_ATTENTION):
    """Phase 3 and 6 for both attention kernels at the new configs' served
    shapes (B 8, T 999 after the prefix; decode at S = T + 32): f32 and
    bf16 under phase 3's criteria, decode over the window's slot map
    (empty slots past pos) and over a ring map with empty slots; then the
    bf16 times beside the plain versions, SDPA and the bound. Returns
    ({label: {"flash": ..., "decode": ...}}, worst bf16 errors)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import EMPTY_SLOT, decode_key_positions

    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    out, worst = {}, {"flash_attention": (0.0, 0.0),
                      "decode_attention": (0.0, 0.0)}
    for label, arch, P in cases:
        cfg = get_config(arch)
        B, H, KV, hd = len(PROMPT_LENS), cfg.n_heads, cfg.n_kv_heads, cfg.hd
        W, T = cfg.sliding_window, P + max(PROMPT_LENS)
        S = T + NEW_TOKENS
        G = H // KV
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            q, k, v = (model_layout(gen, B, T, h, hd, dtype, dev)
                       for h in (H, KV, KV))
            pos = torch.arange(T, dtype=torch.int32, device=dev)
            e_f = check_kernel(
                f"flash_attention {tag} {label} B={B} H={H} KV={KV} T={T} "
                f"hd={hd} window={W}", fk.flash_attention(q, k, v, pos, pos, W),
                attention_ref(*f32(q, k, v), pos, pos, W))
            qd = torch.randn((B, KV, G, hd), generator=gen,
                             device=dev).to(dtype)
            kc, vc = (model_layout(gen, B, S, KV, hd, dtype, dev)
                      for _ in range(2))
            p = T + NEW_TOKENS // 2
            k_pos = decode_key_positions(S, p, W, dev)
            e_d = check_kernel(
                f"decode_attention {tag} {label} B={B} KV={KV} G={G} S={S} "
                f"hd={hd} pos={p}", dk.decode_attention(qd, kc, vc, k_pos, p),
                decode_attention_ref(*f32(qd, kc, vc), k_pos, p))
            slots = torch.arange(S, device=dev)
            ring = 2500 - ((2500 - slots) % S)
            ring[::9] = EMPTY_SLOT
            ring = ring.to(torch.int32)
            check_kernel(f"decode_attention {tag} {label} ring+empty slots",
                         dk.decode_attention(qd, kc, vc, ring, 2500),
                         decode_attention_ref(*f32(qd, kc, vc), ring, 2500))
            if dtype == torch.bfloat16:
                for n, e in (("flash_attention", e_f),
                             ("decode_attention", e_d)):
                    worst[n] = tuple(max(x, y) for x, y in zip(worst[n], e))
                out[label] = {
                    "flash": dict(_time_flash(q, k, v, pos, W, 2),
                                  max_abs_err=e_f[0], max_row_rel_err=e_f[1]),
                    "decode": dict(_time_decode(qd, kc, vc, k_pos, p, 8),
                                   max_abs_err=e_d[0],
                                   max_row_rel_err=e_d[1])}
                for n, t in out[label].items():
                    lib = ("none" if t["library_ms"] is None
                           else f"{t['library_ms']:.4f} ms")
                    print(f"    {n} [{t['shape']}]: {t['ms']:.4f} ms (eager "
                          f"{t['eager_ms']:.4f}), plain {t['plain_ms']:.4f} "
                          f"ms, SDPA {lib}, bound {t['bound_ms']:.4f} ms "
                          f"({t['bound_by']})", flush=True)
        del q, k, v, qd, kc, vc
        torch.cuda.empty_cache()
    return out, worst


def moe_launches_per_step(engine) -> dict:
    """Launches of one decode step of the served batch's size and of one
    MoE layer's `moe_apply` at decode, each from torch.profiler over 10
    replays (phase 9's `_per_call`)."""
    from repro_torch.models import decoder
    from repro_torch.models.decoder import _layer
    from repro_torch.models.moe import moe_apply

    cfg, params = engine.cfg, engine.params
    B = len(PROMPT_LENS)
    toks = torch.ones((B, 16), dtype=torch.long, device=engine.device)
    h = torch.randn((B, 1, cfg.d_model), device=engine.device).to(
        cfg.torch_dtype)
    lp = _layer(params["layers"]["moe"], 0)
    with torch.inference_mode():
        _, cache = decoder.prefill(params, cfg, toks, max_len=20)
        # The same step again and again: it rewrites its own cache slot.
        step = _per_call(f"decode step (B={B}, {cfg.n_layers} layers)",
                         lambda: decoder.decode_step(params, cfg, cache,
                                                     toks[:, :1], 16))
        moe = _per_call("MoE layer's moe_apply at decode",
                        lambda: moe_apply(lp, cfg, h))
    per_layer = (None if step["launches"] is None
                 else step["launches"] / cfg.n_layers)
    print(f"  {per_layer} kernel launches per layer per decode step",
          flush=True)
    return {"decode_step": step, "per_layer_per_step": per_layer,
            "moe_apply_decode": moe}


def serve_moe_io(dev, seed, label, arch, replace, kernels, traced):
    """Phase 4 (and 7) for one engine of MOE_IO_ENGINES: built at full
    width with random weights from `seed`, served, traced when asked, and
    freed before the next. Returns its numbers."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config(arch), **replace)
    T = max(PROMPT_LENS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = serve.build_engine(cfg, dev, seed, max_len=T + NEW_TOKENS,
                                max_batch=len(PROMPT_LENS))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = sum(t.numel() for t in _leaves(engine.params))
    alloc = torch.cuda.memory_allocated() / 2 ** 30
    print(f"  {label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts or 'no'} experts (top {cfg.top_k}), "
          f"{n_par / 1e9:.2f} B parameters drawn in {init_s:.1f}s; "
          f"{alloc:.1f} GiB allocated", flush=True)
    serve.serve_batch(engine, serve.make_requests([16, 9], 2,
                                                  cfg.vocab_size, seed + 1))
    reqs = serve.make_requests(PROMPT_LENS, NEW_TOKENS, cfg.vocab_size, seed)
    launches, runs = serve_counted(engine, reqs, kernels, label, seed)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {label}: peak {peak:.1f} GiB allocated", flush=True)
    int8 = cfg.moe_w8a8
    if int8:
        # The experts are stored K-major: every int8 launch must have gone
        # to the wgmma kernel, none to the N-major one.
        n_all, n_wgmma = launches["int8_grouped_matmul"], launches[INT8_WGMMA]
        print(f"  {label}: int8 launches {n_all}: {n_wgmma} K-major (wgmma), "
              f"{n_all - n_wgmma} N-major (mma.sync); TTFT ms "
              f"{[round(r['ttft_s'] * 1e3, 2) for r in runs]} and tok/s "
              f"{[round(r['tok_per_s'], 1) for r in runs]} against the N-major "
              f"kernel's "
              f"{W8A8_BEFORE['ttft_ms']} and {W8A8_BEFORE['tok_per_s']} "
              f"(from PERF.md)", flush=True)
        if n_wgmma != n_all:
            fail(f"{label}: {n_all - n_wgmma} int8 launches went to the "
                 f"N-major kernel")
    out = {"config": cfg.name, "layers": cfg.n_layers,
           "params_b": n_par / 1e9, "gib_allocated": alloc, "peak_gib": peak,
           "init_s": init_s, "ttft_ms": [r["ttft_s"] * 1e3 for r in runs],
           "tok_per_s": [r["tok_per_s"] for r in runs],
           "launches": {n: c for n, c in launches.items() if c}}
    if traced:
        phase(f"7. device trace of one served {label} batch")
        out["trace"] = trace_batch(engine, reqs, INT8_TRACE if int8 else None)
        out["launch_counts"] = moe_launches_per_step(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_musicgen(dev, seed) -> dict:
    """Phase 4 for musicgen-medium, whole: the engine serves 1-D prompts
    only, so the decoder runs directly, as the reference's tests run it:
    prefill of a [8, 64, 1536] prefix and [8, 999, 4] codebook tokens,
    then 32 greedy decode steps (argmax per codebook), with the attention
    kernels' launch counts set to 0 just before and read just after."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import decoder

    cfg = get_config(MUSICGEN)
    B, T, P, nq = (len(PROMPT_LENS), max(PROMPT_LENS), cfg.n_prefix_embeds,
                   cfg.n_codebooks)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = decoder.init_params(gen, cfg)
    n_par = sum(t.numel() for t in _leaves(params))
    toks = torch.randint(0, cfg.vocab_size, (B, T, nq), generator=gen,
                         device=dev)
    prefix = torch.randn((B, P, cfg.d_model), generator=gen, device=dev)

    def generate(toks, prefix, steps):
        t0 = time.perf_counter()
        with torch.inference_mode():
            Tp = prefix.shape[1] + toks.shape[1]
            lg, cache = decoder.prefill(params, cfg, toks, prefix,
                                        max_len=Tp + steps)
            step = lg[:, -1].argmax(-1)                     # [B, nq]
            out = [step]
            step.tolist()                                   # first tokens
            ttft = time.perf_counter() - t0
            for pos in range(Tp, Tp + steps):
                lg, cache = decoder.decode_step(params, cfg, cache,
                                                step[:, None], pos)
                step = lg[:, -1].argmax(-1)
                out.append(step)
            got = torch.stack(out, dim=1)                   # [B, steps+1, nq]
            got_host = got.tolist()
        return lg, got, got_host, ttft, time.perf_counter() - t0

    generate(toks[:, :16], prefix, 2)                       # warm-up
    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
    lg, got, _, ttft, wall = generate(toks, prefix, NEW_TOKENS)
    launches = {name: op.launches for name, op in ops.items()}
    n_tok = got.numel()
    print(f"  {cfg.name} whole ({cfg.n_layers} layers, {n_par / 1e9:.2f} B "
          f"parameters): prefix [{B}, {P}, {cfg.d_model}] + tokens [{B}, {T},"
          f" {nq}], {NEW_TOKENS} decode steps: TTFT {ttft * 1e3:.2f} ms, "
          f"{n_tok / wall:.1f} codebook tokens/s ({wall:.3f} s); kernel "
          f"launches {launches}", flush=True)
    if (tuple(lg.shape) != (B, 1, nq, cfg.vocab_size)
            or not torch.isfinite(lg).all()
            or not ((got >= 0) & (got < cfg.vocab_size)).all()):
        fail(f"{cfg.name}: logits {tuple(lg.shape)} or tokens out of range")
    for name in ("flash_attention", "decode_attention"):
        if launches[name] <= 0:
            fail(f"{cfg.name}'s run never launched {name}")
    out = {"config": cfg.name, "params_b": n_par / 1e9, "ttft_ms": ttft * 1e3,
           "tok_per_s": n_tok / wall, "wall_s": wall,
           "launches": {n: c for n, c in launches.items() if c}}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


INT8_SOURCE = "src/repro/models/moe.py:64"
# The launch count of the K-major wgmma kernel among the int8 GEMM's
# (`int8_grouped_matmul.wgmma_launches`), under this name in the counts.
INT8_WGMMA = "int8_grouped_matmul_wgmma"
# The served kimi-k2 W8A8 batch on the N-major mma.sync kernel, before the
# int8 GEMM's Hopper redesign (copied from PERF.md §6): TTFT ms and tok/s,
# printed beside this run's and never in the JSON line.
W8A8_BEFORE = {"ttft_ms": (114.0, 115.4), "tok_per_s": (445.5, 488.7)}
# The int8 GEMM's kernels in a trace, by name: the product and its
# pre-pass (int8_grouped_matmul_wgmma.cu), and the activation quantisation
# that feeds it (`_quant_act`'s abs, amax, div, round and cast kernels are
# not told apart from other elementwise work, so it is not listed).
INT8_TRACE = {"int8 wgmma product (gmm_kernel)": ("::gmm_kernel",),
              "int8 pre-pass (flag_kernel, compact_kernel)":
                  ("flag_kernel", "compact_kernel")}


def moe_and_io(dev=None, seed: int = 0) -> dict:
    """Phase 10: the MoE and io configs on the card. To run it alone:
    python -c "import chip_smoke as cs; cs.moe_and_io()". Returns the
    phase's numbers: "int8" (the kernel's times by shape), "attention"
    (by config), "engines", "musicgen", "logits" and "launches" by path."""
    if dev is None:
        if not torch.cuda.is_available():
            fail("no CUDA device")
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {}
    phase("10. MoE and io: kernels vs plain versions (phase 3) and their "
          "times (phase 6) at the new shapes")
    out["attention"], out["attention_worst"] = \
        check_and_time_attention_moe_io(dev, seed)
    out["int8"] = check_and_time_int8(dev, seed)
    out["engines"] = {}
    for label, arch, replace, kernels, traced in MOE_IO_ENGINES:
        phase(f"10. serve {label} (phase 4)")
        out["engines"][label] = serve_moe_io(dev, seed, label, arch, replace,
                                             kernels, traced)
    phase(f"10. {MUSICGEN} with its prefix and codebooks (phase 4)")
    out["musicgen"] = run_musicgen(dev, seed)
    phase("10. full-width logits, kernels vs plain (phase 5)")
    out["logits"] = [compare_paths(dev, seed, arch, n_layers, prefix_rows,
                                   with_f32)
                     for arch, n_layers, prefix_rows, with_f32
                     in MOE_IO_LOGITS]
    out["launches"] = {label: e["launches"]
                       for label, e in out["engines"].items()}
    out["launches"][MUSICGEN] = out["musicgen"]["launches"]
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 10 took {out['wall_s']:.1f}s", flush=True)
    return out


def merge_moe_io_rows(rows, moe_io):
    """Phase 10's numbers in the kernel table: the attention rows gain the
    new paths' launches and their times at the new shapes ("moe_io"); the
    grouped int8 GEMM gets its own row for its served kernel, the K-major
    wgmma one, timed at kimi-k2's routed decode-step w1 shape (the most
    launched: the a of a served step, its bound on the filled experts'
    bytes), its other shapes under "shapes", and the N-major kernel,
    on no served path since, beside it at the same shape ("beside")."""
    for r in rows:
        by_path = {p: n[r["name"]] for p, n in moe_io["launches"].items()
                   if n.get(r["name"])}
        r["launches_by_path"].update(by_path)
        r["launches"] = sum(r["launches_by_path"].values())
        if "attention" in r["name"]:
            key = "flash" if r["name"].startswith("flash") else "decode"
            r["moe_io"] = {label: t[key]
                           for label, t in moe_io["attention"].items()}
    by_path = {p: n[INT8_WGMMA] for p, n in moe_io["launches"].items()
               if n.get(INT8_WGMMA)}
    timed = moe_io["int8"]
    head = timed["kimi-k2-1t-a32b decode w1 routed"]
    rows.append(dict(
        name="int8_grouped_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/int8_grouped_matmul_wgmma.cu",
        replaces=INT8_SOURCE,
        replaces_note="an XLA einsum of the W8A8 experts, not a Pallas "
                      "kernel: the port's own kernel",
        launches=sum(by_path.values()), launches_by_path=by_path,
        library_ms=None, shape=head["shape"] + " routed",
        ms=head["ms"], eager_ms=head["eager_ms"], plain_ms=head["plain_ms"],
        bound_ms=head["routed_bound_ms"], bound_by=head["routed_bound_by"],
        dense_bound_ms=head["bound_ms"], prepass_ms=head["prepass_ms"],
        filled_experts=head["filled_experts"],
        max_abs_err=max(t["max_abs_err"] for t in timed.values()),
        beside=dict(name="int8_grouped_matmul (N-major, mma.sync)",
                    route="cuda",
                    source="src/repro_torch/kernels/csrc/"
                           "int8_grouped_matmul.cu",
                    launches=sum(n.get("int8_grouped_matmul", 0)
                                 - n.get(INT8_WGMMA, 0)
                                 for n in moe_io["launches"].values()),
                    ms=head["nmajor_ms"]),
        shapes=timed))
    return rows


# Phase 11: train on the card. qwen2-0.5b whole at its training shape
# (PackedStream batches of 8 x 2048 tokens), AdamW with a 2-step warmup
# over 20 steps, and the attention backward's checks. The bf16
# gradients are held per row (last axis) at 2e-2 relative, each no more
# than twice as far from the f32 gradient as the plain path run in bf16
# (autograd through the attention math in bf16, what a port without the
# kernel would train with); a row whose exact gradient vanishes is
# measured against 1e-3 of the mean row norm (see `bwd_row_rel`).
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 2048, 20
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
BWD_F32_REL, BWD_BF16_ROW_REL = 2e-5, 2e-2
STEP_F32_REL_L2 = 1e-4      # 2-layer train step, every gradient leaf
# A leaf whose exact gradient is zero has only rounding noise to compare
# (top-1 routing renormalises its one gate to p / p = 1: the router gets
# nothing); as tests/test_torch_train_grads.py holds it, such a leaf (norm
# below 1e-7 of the whole gradient's on the plain path) must stay below
# 1e-7 of it on the kernel path too.
ZERO_GRAD_REL = 1e-7
TRAIN_PATH = f"{ARCH} train ({TRAIN_STEPS} steps)"
# The backward's device ms before its Hopper redesign (the mma.sync
# kernel, which took hd 64 and 128 only; copied from PERF.md), printed
# beside this run's time and never put in the JSON line.
BWD_BEFORE_MS = {"train": 2.6440}
# The attention backward's checks: (label, B, H, KV, Tq, Tk, hd, window, a
# row with no admissible key). "train" is qwen2-0.5b's training shape;
# "hd112" zamba2-7b's shared attention (G 1, window 4096); "hd32" the
# smoke configs' width. Those three are also timed.
BWD_CASES = [("train", TRAIN_B, 14, 2, TRAIN_T, TRAIN_T, 64, 0, False),
             ("ragged", 4, 14, 2, 777, 999, 64, 256, False),
             ("hd128", 2, 64, 8, 1024, 1024, 128, 8192, False),
             ("lost-row", 2, 4, 1, 130, 515, 64, 50, True),
             ("hd112", 2, 32, 32, 1024, 1024, 112, 4096, False),
             ("hd32", 4, 4, 2, 512, 512, 32, 0, False)]
BWD_TIMED = ("train", "hd112", "hd32")


def bwd_row_rel(got, want, wants) -> float:
    """Largest |got - want|_2 / max(|want|_2, 1e-3 R) over the last axis's
    rows, R the mean row norm over `wants` (dq, dk and dv together): the
    first query's dq (it sees key 0 alone: P = 1, dP - D = 0) has no
    relative scale."""
    got, want = got.float(), want.float()
    R = torch.cat([w.float().norm(dim=-1).flatten() for w in wants]).mean()
    return ((got - want).norm(dim=-1)
            / torch.maximum(want.norm(dim=-1), 1e-3 * R)).max().item()


def _plain_bf16_grads(q, k, v, do, q_pos, k_pos, window):
    """dq, dk, dv of the attention math run in bf16 (logits, softmax and
    P V rounded to bf16, as a plain bf16 port would train), by autograd."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    qq, kk, vv = leaves
    G = q.shape[1] // k.shape[1]
    kk, vv = (t.repeat_interleave(G, dim=1) for t in (kk, vv))
    s = (qq @ kk.transpose(-1, -2)) * q.shape[-1] ** -0.5
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    grads = torch.autograd.grad(p @ vv, leaves, do)
    return grads


def check_attention_bwd(dev, seed, cases=BWD_CASES, timed_labels=BWD_TIMED):
    """Phase 11.1 (and 16.2 at the trained families' step shapes): the
    forward's LSE and the backward kernel against their plain versions in
    f32 on the same, exactly upcast inputs (q, k, v, dO and the kernel's
    own o and LSE); in bf16 also the whole gradients' relative L2 distance
    to the exact f32 gradient (the f32 forward's o and LSE), at most twice
    the plain bf16 path's. Returns the worst errors and the bf16 inputs
    of the `timed_labels` cases."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref, lse_ref
    from repro_torch.kernels.flash_attention_bwd import kernel as bk
    from repro_torch.kernels.flash_attention_bwd.ref import \
        flash_attention_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = dict(lse=0.0, f32=0.0, bf16=0.0, bf16_abs=0.0,
                bf16_over_plain=0.0)
    timed = {}
    for label, B, H, KV, Tq, Tk, hd, window, lost in cases:
        q_pos = torch.arange(Tk - Tq, Tk, dtype=torch.int32, device=dev)
        if lost:
            q_pos[3] = -5
        k_pos = torch.arange(Tk, dtype=torch.int32, device=dev)
        base = [model_layout(gen, B, T, h, hd, torch.float32, dev)
                for T, h in ((Tq, H), (Tk, KV), (Tk, KV), (Tq, H))]
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{label} {str(dtype).split('.')[-1]}"
            q, k, v, do = (t.to(dtype) for t in base)
            o, lse = fk.flash_attention(q, k, v, q_pos, k_pos, window,
                                        with_lse=True)
            got = bk.flash_attention_bwd(q, k, v, o, lse, do, q_pos, k_pos,
                                         window)
            again = bk.flash_attention_bwd(q, k, v, o, lse, do, q_pos, k_pos,
                                           window)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"flash_attention_bwd {tag}: two launches differ")
            del again
            lse_want = lse_ref(*f32(q, k), q_pos, k_pos, window)
            if not torch.equal(torch.isinf(lse), torch.isinf(lse_want)):
                fail(f"flash_attention lse {tag}: lost rows marked wrongly")
            fin = torch.isfinite(lse_want)
            lse_err = (lse[fin] - lse_want[fin]).abs().max().item()
            lse_tol = F32_TOL if dtype == torch.float32 else 1e-4
            errs["lse"] = max(errs["lse"], lse_err)
            line = f"  {tag} B={B} H={H} KV={KV} Tq={Tq} Tk={Tk} hd={hd} " \
                   f"window={window}: lse max_abs_err={lse_err:.3e} " \
                   f"(tol {lse_tol:g})"
            if lse_err > lse_tol:
                fail(f"flash_attention lse {tag} disagrees: {lse_err:.3e}")
            want = flash_attention_bwd_ref(*f32(q, k, v, o), lse, do.float(),
                                           q_pos, k_pos, window)
            if dtype == torch.float32:
                rel = max((g - w).abs().max().item()
                          / w.abs().max().clamp_min(1e-30).item()
                          for g, w in zip(got, want))
                errs["f32"] = max(errs["f32"], rel)
                ok = rel <= BWD_F32_REL
                print(f"{line}; dq/dk/dv max_abs_err / max|want| = "
                      f"{rel:.3e} (tol {BWD_F32_REL:g}) "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"flash_attention_bwd {tag} disagrees")
                continue
            o32 = attention_ref(*f32(q, k, v), q_pos, k_pos, window)
            exact = flash_attention_bwd_ref(*f32(q, k, v), o32, lse_want,
                                            do.float(), q_pos, k_pos, window)
            plain = _plain_bf16_grads(q, k, v, do, q_pos, k_pos, window)
            for name, g, w, pl, ex in zip(("dq", "dk", "dv"), got, want,
                                          plain, exact):
                rel = bwd_row_rel(g, w, want)
                dist, dist_plain = _rel_l2(g.float(), ex), _rel_l2(
                    pl.float(), ex)
                errs["bf16"] = max(errs["bf16"], rel)
                errs["bf16_abs"] = max(errs["bf16_abs"],
                                       (g.float() - w).abs().max().item())
                errs["bf16_over_plain"] = max(errs["bf16_over_plain"],
                                              dist / dist_plain)
                ok = rel <= BWD_BF16_ROW_REL and dist <= 2 * dist_plain
                print(f"{line}; {name} max_row_rel_err={rel:.3e} (tol "
                      f"{BWD_BF16_ROW_REL:g}); rel L2 to the exact f32 "
                      f"gradient {dist:.3e}, the plain bf16 path's "
                      f"{dist_plain:.3e} (tol 2x) "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"flash_attention_bwd {tag} {name} disagrees")
            if label in timed_labels:
                timed[label] = (q, k, v, o, lse, do, q_pos, k_pos, window)
            del plain, exact, o32
        del base, want, got
        torch.cuda.empty_cache()
    return errs, timed


def _grads(params, cfg, batch, use_kernels):
    from repro_torch.models import decoder
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.train_loop import as_trainable

    params = as_trainable(params)
    loss = decoder.train_loss(params, cfg, batch, use_kernels=use_kernels)
    return loss.detach(), list(torch.autograd.grad(loss, leaves(params)))


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def check_train_step(dev, seed, arch=ARCH, n_layers=2, B=TRAIN_B,
                     T=TRAIN_T, prefix_rows=0):
    """Phase 11.2 (and 12.2, 16.2): `arch` at full width, `n_layers` of
    its layers (qwen2-0.5b: 2 of 24), one training batch of B x T tokens
    (codebook tokens for an audio config) after `prefix_rows` prefix
    embeddings: loss and every gradient leaf, kernels vs plain, in f32 and
    in bf16 (the same bf16-rounded weights). A config with scans also
    takes the f32 gradients with the scan kernels' outputs set to the
    plain path's values (`scan_values_from_plain`): the backward kernels
    alone, every leaf at STEP_F32_REL_L2 of the plain path. rwkv6's
    end-to-end f32 leaves are printed, not held: its per-head group norm
    divides y by its rms, ~1e-3 on some rows where the median is ~1e2, so
    the forward kernel's f32 rounding of y (within 2e-5, phase 6) moves
    some leaves by ~1e-2. An MoE config's four runs take the f32 kernel
    path's expert choices (`same_routes`; each run's own choices that
    differ are counted and printed): the two attentions differ by
    rounding, which can move a token across a router tie and change a
    whole expert's gradient with no fault in any kernel. f32 gradients
    larger than a quarter of the card wait on the host while the plain
    path runs (llama4-scout's 2 layers: 6.5e9 parameters)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    from repro_torch.training.train_loop import batch_on

    cfg16 = dataclasses.replace(get_config(arch), n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    params16 = decoder.init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg16)
    params32 = _tree_map(lambda x: x.float(), params16)
    batch = batch_on(PrefixStream(cfg16, B, prefix_rows, T).batch(0), dev)
    names = [n for n, _ in sorted(_named(params16))]
    routes, logits = ([], []) if cfg16.n_experts else (None, None)
    flips = {}

    def grads(params, cfg, use_kernels, label):
        with same_routes(routes, flips.setdefault(label, []), logits):
            return _grads(params, cfg, batch, use_kernels)

    lk, gk = grads(params32, cfg32, True, "f32 kernels")
    if routes is not None:
        from repro_torch.models import moe
        flips.pop("f32 kernels")
        balance = [moe.load_balance_loss(lg, idx, cfg16.n_experts).item()
                   for lg, idx in zip(logits, routes, strict=True)]
        logits = None
    f32_bytes = sum(g.numel() * 4 for g in gk)
    on_host = f32_bytes > torch.cuda.get_device_properties(
        dev).total_memory / 4
    if on_host:
        gk = [g.cpu() for g in gk]
        torch.cuda.empty_cache()
    lp, gp = grads(params32, cfg32, False, "f32 plain")
    isolate = cfg16.token_mixer in ("mamba2", "rwkv6")
    if not isolate:         # the f32 weights' last use
        del params32
        torch.cuda.empty_cache()
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    total = torch.stack([b.float().norm() for b in gp]).norm().item()
    zero = {n: ZERO_GRAD_REL * total for n, b in zip(names, gp)
            if b.norm().item() < ZERO_GRAD_REL * total}
    worst = max((_rel_l2(a.to(dev), b), n)
                for n, a, b in zip(names, gk, gp) if n not in zero)
    zero_k = {n: a.float().norm().item() for n, a in zip(names, gk)
              if n in zero}
    held = cfg16.token_mixer != "rwkv6"
    ok = (loss_rel <= 1e-5 and (worst[0] <= STEP_F32_REL_L2 or not held)
          and all(v < zero[n] for n, v in zero_k.items()))
    isolated = None
    if isolate:
        with scan_values_from_plain():
            _, gh = _grads(params32, cfg32, batch, True)
        isolated = max((_rel_l2(a, b), n) for n, a, b in zip(names, gh, gp)
                       if n not in zero)
        ok = ok and isolated[0] <= STEP_F32_REL_L2
        del gh, params32
    where = (f" B={B} T={T}" + (f" after {prefix_rows} prefix rows"
                                if prefix_rows else "")
             + (f", {cfg16.n_codebooks} codebooks" if cfg16.n_codebooks
                else ""))
    print(f"  f32 {arch} ({n_layers} layers) train step{where}, "
          f"kernels vs plain: loss {lk.item():.6f} vs {lp.item():.6f} "
          f"(rel {loss_rel:.2e}, tol 1e-05); worst gradient leaf "
          f"{worst[1]} rel L2 {worst[0]:.3e} "
          + (f"(tol {STEP_F32_REL_L2:g})" if held else "(printed, not held)")
          + ("" if isolated is None else
             f"; the backward kernels on the plain path's scan values: "
             f"worst leaf {isolated[1]} rel L2 {isolated[0]:.3e} (tol "
             f"{STEP_F32_REL_L2:g})")
          + (f"; the kernel path's f32 gradients ({f32_bytes / 2 ** 30:.1f}"
             f" GiB) held on the host" if on_host else "")
          + (f"; leaves whose exact gradient is zero, their norm on the "
             f"kernel path (tol {ZERO_GRAD_REL:g} x the whole gradient's "
             f"{total:.3e}): {zero_k}" if zero else "")
          + f" {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the f32 train step's kernels and plain paths disagree")
    # bf16: the f32 gradient of the same bf16-rounded weights (the plain
    # path's, just computed) is the truth. Each path's distances to it
    # are taken before the other path runs: one bf16 gradient at a time.
    del gk
    torch.cuda.empty_cache()
    lt, gt = lp, gp

    def to_truth(label, use_kernels):
        loss, g16 = grads(params16, cfg16, use_kernels, label)
        rel = {n: a.float().norm().item() if n in zero else _rel_l2(a, t)
               for n, a, t in zip(names, g16, gt)}
        del g16
        torch.cuda.empty_cache()
        return loss, rel

    l16k, rel_k = to_truth("bf16 kernels", True)
    l16p, rel_p = to_truth("bf16 plain", False)
    out = {"f32_loss_rel": loss_rel, "f32_worst_leaf_rel_l2": worst[0],
           "f32_worst_leaf": worst[1], "f32_leaves_held": held,
           "f32_bwd_kernels_on_plain_values": isolated, "bf16_leaves": {}}
    if routes is not None:
        out.update(moe_calls=len(routes), tokens_routed_otherwise=flips,
                   load_balance_loss=balance)
        print(f"  {arch}: the four runs take the f32 kernel path's expert "
              f"choices ({len(routes)} router calls: forward and remat; "
              f"switch load-balance loss {[round(x, 4) for x in balance]}); "
              f"tokens whose own choice differed, per call: {flips}",
              flush=True)
    bad = []
    for n in names:
        if n in zero:
            out.setdefault("bf16_zero_leaves", {})[n] = rel_k[n]
            if rel_k[n] >= zero[n]:
                bad.append(n)
            continue
        rk, rp = rel_k[n], rel_p[n]
        out["bf16_leaves"][n] = (rk, rp)
        if rk > 2 * rp + E2E_TOL:
            bad.append(n)
    worst16 = max(out["bf16_leaves"].items(), key=lambda kv: kv[1][0])
    print(f"  bf16 {arch} ({n_layers} layers) train step: loss kernels "
          f"{l16k.item():.5f}, plain {l16p.item():.5f}, f32 "
          f"{lt.item():.5f}; worst leaf {worst16[0]}: rel L2 to the f32 "
          f"gradient kernels {worst16[1][0]:.3e}, plain "
          f"{worst16[1][1]:.3e} (tol 2x plain + {E2E_TOL:g}) "
          + (f"; leaves whose exact gradient is zero, norm on the kernel "
             f"path {out['bf16_zero_leaves']} (tol {ZERO_GRAD_REL:g} x "
             f"{total:.3e}) " if zero else "")
          + f"{'ok' if not bad else 'MISMATCH ' + str(bad)}", flush=True)
    if bad:
        fail(f"bf16 train-step gradients too far from f32: {bad}")
    out["f32_zero_leaves"] = zero_k
    del params16, gt, gp
    torch.cuda.empty_cache()
    return out


class PrefixStream:
    """`PackedStream` batches of B x T tokens (B x T x n_codebooks for an
    audio config), seed 0, each with P prefix embeddings [B, P, d_model]
    (the VLM's image rows, the audio model's conditioning) drawn from
    (seed, step) when P > 0: the training batches of a prefix config."""

    def __init__(self, cfg, B, P, T, seed=0):
        from repro_torch.training.data import DataConfig, PackedStream
        self.tokens = PackedStream(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=T, batch_size=B,
            n_codebooks=cfg.n_codebooks, seed=seed))
        self.prefix, self.seed = (B, P, cfg.d_model), seed
        self.B, self.P, self.T = B, P, T

    def batch(self, step: int) -> dict:
        out = self.tokens.batch(step)
        if self.prefix[1]:
            out["prefix"] = np.random.default_rng(
                (self.seed, step, 1)).standard_normal(self.prefix,
                                                      dtype=np.float32)
        return out


def same_choices(a, b):
    """Per token, whether two [N, k] expert choices pick the same set."""
    return (a.sort(dim=-1).values == b.sort(dim=-1).values).all(-1)


@contextlib.contextmanager
def same_routes(record, differ, logits=None):
    """The MoE router's expert choices, fixed across runs: with `record`
    an empty list, `moe.route` runs unchanged and each call appends its
    expert choices to `record` (and, given a list `logits`, its router
    logits, detached, for the load-balance loss); with `record` filled,
    the calls take its choices in call order (gates: this run's router
    probabilities at those experts, renormalised, as `moe.route` computes
    them) and `differ` gets, per call, the count of tokens whose own
    choice differs. `record` None: no MoE, nothing changes."""
    if record is None:
        yield
        return
    from repro_torch.models import moe

    route, replay, calls = moe.route, bool(record), iter(list(record))

    def fixed(p, cfg, xf):
        gate, idx = route(p, cfg, xf)
        if not replay:
            record.append(idx)
            if logits is not None:
                logits.append((xf.float() @ p["router"]).detach())
            return gate, idx
        want = next(calls)
        differ.append(int((~same_choices(idx, want)).sum()))
        g = torch.softmax(xf.float() @ p["router"], dim=-1).gather(-1, want)
        return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9), want

    moe.route = fixed
    try:
        yield
    finally:
        moe.route = route


@contextlib.contextmanager
def scan_values_from_plain():
    """The models' scan ops launch the kernels as ever (the forward, and
    under autograd the backward), but their outputs take, bit for bit,
    the values of the plain path's chunked scans (`use_kernels=False`):
    the gradient that reaches each backward kernel is then the plain
    path's own, so the backward kernels are held apart from the forward
    kernels' rounding."""
    from repro_torch.models import mamba2, rwkv6

    def ssd_plain(x, Bm, Cm, dt, A, D, S0):
        if S0 is None:
            S0 = x.new_zeros((x.shape[0], x.shape[2], x.shape[3],
                              Bm.shape[2]))
        y, S = mamba2._ssd_chunked(dt * A, x, Bm, Cm, dt, S0)
        return y + D[:, None] * x, S

    def wkv_plain(r, k, v, lw, u, S0):
        if S0 is None:
            S0 = r.new_zeros((r.shape[0], r.shape[2], r.shape[3],
                              r.shape[3]))
        return rwkv6._wkv_chunked(r, k, v, lw, u, S0)

    def valued(op, plain):
        def run(*args):
            outs = op(*args)
            with torch.no_grad():
                vals = plain(*args)
            # v + (o - o): exactly v's value, o's gradient.
            return tuple(v + (o - o.detach()) for v, o in zip(vals, outs))
        return run

    saved = mamba2.ssm_scan, rwkv6.rwkv6_wkv
    mamba2.ssm_scan = valued(saved[0], ssd_plain)
    rwkv6.rwkv6_wkv = valued(saved[1], wkv_plain)
    try:
        yield
    finally:
        mamba2.ssm_scan, rwkv6.rwkv6_wkv = saved


def _named(tree, prefix=""):
    """(path, tensor) of every leaf, dict keys sorted as `leaves` orders
    them."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _step_ms(*histories) -> list[float]:
    """Per-step wall ms from train()'s log_every=1 histories (each
    history's wall clock starts at its own first step)."""
    out = []
    for h in histories:
        walls = [0.0] + [r["wall_s"] for r in h]
        out += [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    return out


def profile_step(step_fn, params, opt_state, batch):
    """One more training step under torch.profiler: its wall ms, the
    device's busy ms and share, launches and the twelve kernels that take
    the most device time; None when the profiler saw no CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        float(out[2]["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    rows = device_rows(prof)
    if not rows:
        print("  device trace: not measured (the profiler saw no CUDA "
              "kernels)")
        return None
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    trace = dict(wall_ms=wall_ms, busy_ms=busy_ms, busy=busy_ms / wall_ms,
                 launches=sum(e.count for e in rows),
                 top=[(e.key[:80], e.self_device_time_total / 1e3, e.count)
                      for e in sorted(rows, key=lambda e:
                                      -e.self_device_time_total)[:12]])
    print(f"  one traced step: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * trace['busy']:.1f}% busy), "
          f"{trace['launches']} kernel launches", flush=True)
    for key, t, n in trace["top"]:
        print(f"    {t:9.3f} ms  {n:6d}x  {key}")
    return trace


def train_on_card(dev, seed, ckpt_dir):
    """Phase 11.3-11.4: qwen2-0.5b whole in bf16 trains 20 steps through
    the launcher's `train` (10 steps, a checkpoint, then 10 more from the
    live state), launch counts per step, step times, peak memory and one
    step under torch.profiler; then the step-10 checkpoint restored
    bitwise and 3 steps from it against 3 from the live state. The steps
    consume their trees in place (the reference's donated buffers), so
    the step-10 state those checks need is copied to the host first."""
    from repro_torch.configs import get_config
    from repro_torch.training import checkpoint
    from repro_torch.training.data import DataConfig, PackedStream
    from repro_torch.training.optimizer import AdamWConfig, leaves
    from repro_torch.training.train_loop import batch_on, make_train_step, \
        train

    cfg = get_config(ARCH)
    opt = AdamWConfig(**TRAIN_OPT)
    stream = PackedStream(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=TRAIN_T, batch_size=TRAIN_B,
                                     seed=0))
    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    half = TRAIN_STEPS // 2
    p10, h1, s10 = train(cfg, opt, stream, half, rng=gen, log_every=1,
                         ckpt_path=ckpt_dir, ckpt_every=half, device=dev,
                         return_state=True)
    live = _tree_map(lambda x: x.detach().cpu(),
                     dict(params=p10, opt_state=s10))
    _, h2, _ = train(cfg, opt, stream, TRAIN_STEPS, log_every=1, params=p10,
                     opt_state=s10, device=dev, return_state=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {name: op.launches for name, op in ops.items()}
    hist = h1 + h2
    losses = [h["loss"] for h in hist]
    ms = _step_ms(h1, h2)
    med = float(np.median(ms[3:]))
    n_par = sum(t.numel() for t in leaves(p10))
    print(f"  {ARCH} whole ({cfg.n_layers} layers, {n_par / 1e9:.3f} B "
          f"parameters, bf16) {TRAIN_STEPS} steps of B={TRAIN_B} "
          f"T={TRAIN_T}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"  step ms {[round(x, 1) for x in ms]}; median of steps 4-"
          f"{TRAIN_STEPS} {med:.1f} ms, {TRAIN_B * TRAIN_T / med * 1e3:.0f} "
          f"tokens/s; peak {peak:.2f} GiB allocated; launches {launches}",
          flush=True)
    if not losses[-1] < losses[0] - 0.2:
        fail(f"the loss did not fall by 0.2: {losses[0]} -> {losses[-1]}")
    want = {"flash_attention": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.n_layers * TRAIN_STEPS}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times in "
                 f"{TRAIN_STEPS} steps, want {n}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite losses {losses}")

    trace = profile_step(make_train_step(cfg, opt), p10, s10,
                         batch_on(stream.batch(TRAIN_STEPS), dev))

    # Phase 11.4: the step-10 checkpoint, restored into fresh tensors.
    del p10, s10
    saved, meta = checkpoint.restore(ckpt_dir, dev)
    if meta != dict(step=half, arch=cfg.name):
        fail(f"checkpoint meta {meta}")
    pairs = list(zip(_named(saved), _named(live)))
    for (n1, a), (n2, b) in pairs:
        if n1 != n2 or a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            fail(f"checkpoint leaf {n1} is not what was saved ({n2})")
    print(f"  checkpoint at step {half}: {len(pairs)} leaves restored bit "
          f"for bit", flush=True)
    three = dict(log_every=1, device=dev)
    live = _tree_map(lambda x: x.to(dev), live)
    _, again = train(cfg, opt, stream, half + 3, params=live["params"],
                     opt_state=live["opt_state"], **three)
    _, resumed = train(cfg, opt, stream, half + 3, params=saved["params"],
                       opt_state=saved["opt_state"], **three)
    live1 = [h["loss"] for h in h2[:3]]
    live2 = [h["loss"] for h in again]
    res = [h["loss"] for h in resumed]
    spread = [abs(a - b) for a, b in zip(live1, live2)]
    ok = all(abs(r - a) <= s for r, a, s in zip(res, live1, spread))
    print(f"  steps {half + 1}-{half + 3}: from the checkpoint {res}, "
          f"from the live state {live1} and again {live2} (spread "
          f"{spread}) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("steps from the restored checkpoint differ from the live ones "
             "beyond the spread of two live runs")
    result = dict(config=cfg.name, layers=cfg.n_layers, params_b=n_par / 1e9,
                  batch=TRAIN_B, seq=TRAIN_T, steps=TRAIN_STEPS,
                  losses=losses, step_ms=ms, median_step_ms=med,
                  tokens_per_s=TRAIN_B * TRAIN_T / med * 1e3, peak_gib=peak,
                  launches=launches,
                  launches_per_step={k: launches[k] / TRAIN_STEPS
                                     for k in want},
                  trace=trace, resume=dict(restored=res, live=live1,
                                           live_again=live2))
    del saved, live
    torch.cuda.empty_cache()
    return result


def admitted_pairs(q_pos, k_pos, window) -> int:
    """(query, key) pairs the causal/window bound admits."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return int(ok.sum().item())


def time_attention_bwd(timed):
    """Phase 11.5: the backward kernel at each BWD_TIMED shape beside its
    bound, its plain version and SDPA's backward (through autograd, a
    yardstick the port never calls); at the training shape also the
    forward with and without its LSE output. Returns the training
    shape's numbers with every shape's under "by_shape"."""
    rows = time_attention_bwd_rows(timed)
    main = dict(rows["train"])
    main["by_shape"] = [{k: v for k, v in r.items()
                         if k not in ("fwd_ms", "fwd_with_lse_ms")}
                        for r in rows.values()]
    return main


def time_attention_bwd_rows(timed) -> dict:
    """The backward's times at each shape of `timed` ({label: inputs}),
    by label (see `time_attention_bwd`)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention_bwd import kernel as bk
    from repro_torch.kernels.flash_attention_bwd.ref import \
        flash_attention_bwd_ref

    rows = {}
    for label, (q, k, v, o, lse, do, q_pos, k_pos, window) in timed.items():
        B, H, T, hd = q.shape
        sets = [(q, k, v, o, lse, do)] + [
            tuple(t.clone(memory_format=torch.preserve_format)
                  for t in (q, k, v, o, lse, do)) for _ in range(2)]
        ms, eager = time_ms([lambda a=a: bk.flash_attention_bwd(
            *a, q_pos, k_pos, window) for a in sets], n=24)
        pairs = admitted_pairs(q_pos, k_pos, window)
        # Read q, o, dO, k, v, lse and the positions once; write dq, dk, dv.
        n_bytes = (q.element_size() * (4 * q.numel() + 2 * k.numel()
                                       + 2 * v.numel())
                   + 4 * lse.numel() + 4 * 2 * T)
        b, by = bound(n_bytes, 5 * 2.0 * pairs * hd * B * H)
        plain = _event_ms(lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, q_pos, k_pos, window), 2)
        # SDPA's causal mask is the bound here (window 0 or >= T).
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        lib = _event_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                    retain_graph=True), 10)
        del out, leaves
        row = dict(ms=ms, eager_ms=eager, plain_ms=plain, bound_ms=b,
                   bound_by=by, library_ms=lib,
                   shape=f"B={B} H={H} KV={k.shape[1]} T={T} hd={hd} "
                         f"bfloat16 causal"
                         + (f" window={window}" if window else ""))
        before = (f"; before the redesign, from PERF.md: "
                  f"{BWD_BEFORE_MS[label]}" if label in BWD_BEFORE_MS
                  else "")
        line = (f"  flash_attention_bwd [{row['shape']}]: {ms:.4f} ms "
                f"(eager {eager:.4f}{before}), bound {b:.4f} ms ({by}; "
                f"{100 * b / ms:.1f}% of it), "
                f"plain {plain:.2f} ms, SDPA backward {lib:.4f} ms")
        if label == "train":
            for with_lse in (False, True):
                row["fwd_with_lse_ms" if with_lse else "fwd_ms"] = time_ms(
                    [lambda a=a, w=with_lse: fk.flash_attention(
                        *a[:3], q_pos, k_pos, 0, with_lse=w) for a in sets])[0]
            line += (f"; forward {row['fwd_ms']:.4f} ms, with LSE "
                     f"{row['fwd_with_lse_ms']:.4f} ms")
        print(line, flush=True)
        rows[label] = row
        del sets
    return rows


def train_and_check(dev=None, seed: int = 0) -> dict:
    """Phase 11: train on the card. Returns {"training": ..., "bwd_row":
    the kernel table's backward row}; fails on any check."""
    import tempfile

    dev = dev or torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase("11. train: the attention backward vs its plain version")
    errs, timed_inputs = check_attention_bwd(dev, seed)
    phase("11. train: a 2-layer full-width train step, kernels vs plain")
    step = check_train_step(dev, seed)
    phase(f"11. train {ARCH} on the card")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        run = train_on_card(dev, seed, ckpt)
    phase("11. train: kernel times")
    timed = time_attention_bwd(timed_inputs)
    del timed_inputs
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"  phase 11 took {wall:.1f}s", flush=True)
    bwd_row = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces=SOURCES["flash_attention"],
        replaces_note="the backward of the flash-attention kernel; the "
                      "reference differentiates its XLA attention instead",
        launches=run["launches"]["flash_attention_bwd"],
        launches_by_path={TRAIN_PATH: run["launches"]["flash_attention_bwd"]},
        max_abs_err=errs["bf16_abs"], max_row_rel_err=errs["bf16"],
        f32_max_rel_err=errs["f32"],
        **{k: v for k, v in timed.items()
           if k not in ("fwd_ms", "fwd_with_lse_ms")})
    return dict(training=dict(run, attention_bwd_errors=errs,
                              train_step_check=step, wall_s=wall,
                              fwd_ms=timed["fwd_ms"],
                              fwd_with_lse_ms=timed["fwd_with_lse_ms"]),
                bwd_row=bwd_row)


# Phase 12: train the recurrent models on the card. The scans' backward
# kernels are held against their plain versions (the stepwise formulas,
# which keep T + 1 states: at the training shape B is cut where they would
# not fit half the free memory, and the cut is printed) at the training
# shape (B 8, T 2048) from a zero state with no final-state gradient (the
# training path), at the served T 999 from a nonzero state with one, and at
# T 77 from zeros with one; rwkv6 also at the models' weak decay. f32
# gradients at 2e-5 of max|want|; the bf16 gradients (dx, dBm, dCm; dr, dk,
# dv, dlw) under phase 11's criteria, the plain bf16 path being the plain
# version's f32 gradient rounded to bf16 (what it returns on bf16 inputs);
# the f32 gradients of a bf16 call (dt, A, D, u, the state) at 2e-5. Then a
# full-width train step kernels vs plain (phase 11.2's criteria) at T 999
# (a ragged last chunk), B 4, and 10 steps of each model in bf16 through
# `train()` at phase 5's depths.
RECURRENT_TRAIN = {"rwkv6-7b": 4, "zamba2-7b": 7}
# Train-step depths.
RECURRENT_STEP = {"rwkv6-7b": 2, "zamba2-7b": 7}
RECURRENT_STEPS = 10
STEP_B, STEP_T = 4, 999
SCAN_GRADS = {"ssm_scan": ("dx", "dBm", "dCm", "ddt", "dA", "dD", "dstate"),
              "rwkv6_wkv": ("dr", "dk", "dv", "dlw", "du", "dstate")}
# (label, B, T, a nonzero state in, a final-state gradient, log-decay shift)
SCAN_BWD_CASES = [("train", TRAIN_B, TRAIN_T, False, False, -1.5),
                  ("T 999", 8, 999, True, True, -1.5),
                  ("T 77", 8, 77, False, True, -1.5),
                  ("T 999 weak decay", 8, 999, True, True, -6.0)]


def recurrent_path(arch: str) -> str:
    return f"{arch} train ({RECURRENT_STEPS} steps)"


def _scan_fns(name):
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv_bwd import kernel as wbk
    from repro_torch.kernels.rwkv6_wkv_bwd.ref import rwkv6_wkv_bwd_ref
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan_bwd import kernel as sbk
    from repro_torch.kernels.ssm_scan_bwd.ref import ssm_scan_bwd_ref
    if name == "ssm_scan":
        return sk.ssm_scan, sbk.ssm_scan_bwd, ssm_scan_bwd_ref, 3
    return wk.rwkv6_wkv, wbk.rwkv6_wkv_bwd, rwkv6_wkv_bwd_ref, 4


def _plain_fits(name, B, T) -> int:
    """The largest B' <= B (halving) whose T + 1 plain-version states take
    at most half the free device memory."""
    row = (112 * 64 * 64 if name == "ssm_scan" else 64 * 64 * 64) * 4
    free = torch.cuda.mem_get_info()[0]
    while B > 1 and (T + 1) * B * row > free / 2:
        B //= 2
    return B


def check_scan_bwd(dev, seed):
    """Phase 12.1: each scan's backward kernel, on the forward kernel's
    chunk states, against its plain version; two launches bitwise equal.
    Returns the worst errors by kernel and dtype and the training shape's
    f32 inputs of each kernel (for 12.4)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    errs, timed = {}, {}
    for name in SCAN_GRADS:
        fwd, bwd, plain, n_cast = _scan_fns(name)
        for label, B, T, with_state, with_ds, shift in SCAN_BWD_CASES:
            if "weak" in label and name == "ssm_scan":
                continue
            if T == TRAIN_T:
                cut = _plain_fits(name, B, T)
                if cut < B:
                    print(f"  {name} {label}: B cut from {B} to {cut}, so "
                          f"that the plain version's {T + 1} states fit "
                          f"half the free memory", flush=True)
                B = cut
            for dtype in (torch.float32, torch.bfloat16):
                tag = f"{name} {label} {str(dtype).split('.')[-1]}"
                *args, s0 = scan_inputs(name, dtype, gen, dev, T=T, B=B,
                                        decay_shift=shift)
                state = s0 if with_state else None
                dy = torch.randn(args[0].shape, generator=gen,
                                 device=dev).to(dtype)
                ds = (torch.randn(s0.shape, generator=gen, device=dev)
                      if with_ds else None)
                _, _, states = fwd(*args, state, with_states=True)
                got = bwd(*args, states, dy, ds)
                again = bwd(*args, states, dy, ds)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{tag}: two launches of the backward differ")
                del again
                args32 = [*f32(*args[:n_cast]), *args[n_cast:]]
                want = plain(*args32, state, dy.float(), ds)
                worst, bad = {}, []
                for gname, g, w in zip(SCAN_GRADS[name], got, want):
                    if g.dtype == torch.float32:
                        err = (g - w).abs().max().item()
                        rel = err / max(w.abs().max().item(), 1e-30)
                        ok = rel <= BWD_F32_REL
                        key = "f32"
                        errs[name, "f32_abs"] = max(
                            errs.get((name, "f32_abs"), 0.0), err)
                    else:
                        # The plain bf16 path: the plain f32 gradient
                        # rounded to bf16, as the plain version returns it.
                        rel = bwd_row_rel(g, w, [w])
                        dist = _rel_l2(g.float(), w)
                        dist_plain = _rel_l2(w.to(dtype).float(), w)
                        ok = (rel <= BWD_BF16_ROW_REL
                              and dist <= 2 * dist_plain)
                        key = "bf16"
                        errs[name, "bf16_over_plain"] = max(
                            errs.get((name, "bf16_over_plain"), 0.0),
                            dist / max(dist_plain, 1e-30))
                    errs[name, key] = max(errs.get((name, key), 0.0), rel)
                    worst[gname] = rel
                    if not ok:
                        bad.append(gname)
                print(f"  {tag} B={B} T={T}, state "
                      f"{'in' if with_state else 'zeros'}, d(state_out) "
                      f"{'nonzero' if with_ds else 'zero'}: "
                      f"bitwise repeat ok; errors (f32: of max|want|, tol "
                      f"{BWD_F32_REL:g}; bf16: per row, tol "
                      f"{BWD_BF16_ROW_REL:g}, and 2x the plain bf16 L2) "
                      + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                      + (" ok" if not bad else f" MISMATCH {bad}"),
                      flush=True)
                if bad:
                    fail(f"{tag}: {bad} disagree with the plain version")
                if label == "train" and dtype == torch.float32:
                    timed[name] = (args, s0, states, dy)
                del got, want, states, args, args32
                torch.cuda.empty_cache()
    return errs, timed


def train_counted(cfg, opt, stream, steps, per_step, label, dev,
                  seed) -> dict:
    """`steps` bf16 steps of `cfg` on a PrefixStream's batches through the
    launcher's `train` (phases 12.3 and 16.2): launches a step exactly
    `per_step` of each kernel of the path and none of any other, the loss
    must fall; step times, peak memory, the largest leaf and one profiled
    step."""
    import gc

    from repro_torch.training.optimizer import leaves
    from repro_torch.training.train_loop import batch_on, make_train_step, \
        train

    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, hist, state = train(cfg, opt, stream, steps, rng=gen,
                                log_every=1, device=dev, return_state=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    launches = {name: op.launches for name, op in ops.items()}
    losses = [h["loss"] for h in hist]
    ms = _step_ms(hist)
    med = float(np.median(ms[2:]))
    n_par = sum(t.numel() for t in leaves(params))
    largest = max(t.numel() for t in leaves(params))
    B, P, T = stream.B, stream.P, stream.T
    print(f"  {label}: {n_par / 1e9:.3f} B parameters, bf16, vocabulary "
          f"{cfg.vocab_size}; {steps} steps of B={B} x "
          + (f"(P={P} + T={T})" if P else f"T={T}")
          + f": loss {losses[0]:.4f} -> {losses[-1]:.4f}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"  step ms {[round(x, 1) for x in ms]}; median of steps 3-"
          f"{steps} {med:.1f} ms, {B * T / med * 1e3:.0f} tokens/s"
          + (" (B x T, the prefix rows not counted)" if P else "")
          + f"; peak {peak:.2f} GiB allocated ({reserved:.2f} reserved); "
          f"launches {launches}",
          flush=True)
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    for name, n in per_step.items():
        if launches[name] != n * steps:
            fail(f"{label}: {name} launched {launches[name]} times in "
                 f"{steps} steps, want {n} a step")
    extra = {k: v for k, v in launches.items() if v and k not in per_step}
    if extra:
        fail(f"{label}: kernels off the training path launched: {extra}")
    print(f"  launches per step as expected: {per_step}", flush=True)
    trace = profile_step(make_train_step(cfg, opt), params, state,
                         batch_on(stream.batch(steps), dev))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(config=cfg.name, layers=cfg.n_layers, params_b=n_par / 1e9,
                largest_leaf_b=largest / 1e9, vocab_size=cfg.vocab_size,
                batch=B, prefix_rows=P, seq=T, steps=steps, losses=losses,
                step_ms=ms, median_step_ms=med,
                tokens_per_s=B * T / med * 1e3, peak_gib=peak,
                peak_reserved_gib=reserved, launches=launches,
                launches_per_step=per_step, trace=trace)


def train_recurrent_on_card(arch, dev, seed):
    """Phase 12.3: `arch` at published widths and phase 5's depth, bf16,
    trains RECURRENT_STEPS steps of PackedStream(vocab, 2048, 8, seed 0)
    through the launcher's `train` (`train_counted`), with exact launch
    counts per step of every kernel of its path."""
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import _hybrid_shape
    from repro_torch.training.optimizer import AdamWConfig

    cfg = dataclasses.replace(get_config(arch),
                              n_layers=RECURRENT_TRAIN[arch])
    # Per step: each layer's scan runs forward twice under remat (the
    # hybrid's tail layers once) and backward once; the hybrid's shared
    # attention once per super-block, likewise.
    r = 2 if cfg.remat else 1
    if cfg.attn_every:
        n_super, tail = _hybrid_shape(cfg)
        per_step = {"ssm_scan": r * n_super * cfg.attn_every + tail,
                    "ssm_scan_bwd": cfg.n_layers,
                    "flash_attention": r * n_super,
                    "flash_attention_bwd": n_super}
    else:
        per_step = {"rwkv6_wkv": r * cfg.n_layers,
                    "rwkv6_wkv_bwd": cfg.n_layers}
    return train_counted(
        cfg, AdamWConfig(**TRAIN_OPT), PrefixStream(cfg, TRAIN_B, 0, TRAIN_T),
        RECURRENT_STEPS, per_step,
        f"{arch} ({cfg.n_layers} of {get_config(arch).n_layers} layers)",
        dev, seed)


# Each backward's phase-12.4 time before its Hopper redesign (the first,
# scalar kernels, PERF.md's kernel table, NVIDIA H100 80GB HBM3 at 700 W):
# printed beside this run's for reading only, never in the JSON line.
BWD_BEFORE_REDESIGN_MS = {"ssm_scan": 22.4415, "rwkv6_wkv": 17.6985}
# The backwards' chunk kernels at the models' widths, f32 (mangled names).
BWD_CHUNK_KERNELS = {"ssm_scan": "ssd_bwd_kernelIfLi64ELi64E",
                     "rwkv6_wkv": "wkv_bwd_kernelIfLi64E"}


def bwd_sass(name) -> dict:
    """The opcode counts of `name`'s backward chunk kernel (cuobjdump);
    fails unless it holds tensor-core products (HMMA)."""
    from repro_torch.kernels import _build
    mixes = [m for fn, m in _build.opcode_mix(f"{name}_bwd").items()
             if BWD_CHUNK_KERNELS[name] in fn]
    if len(mixes) != 1:
        fail(f"{name}_bwd: {len(mixes)} SASS functions match "
             f"{BWD_CHUNK_KERNELS[name]}")
    mix = mixes[0]
    print(f"  sass {name}_bwd {BWD_CHUNK_KERNELS[name]}: HMMA {mix['HMMA']} "
          f"of {sum(mix.values())} instructions; "
          + ", ".join(f"{k} {v}" for k, v in mix.most_common(8)), flush=True)
    if not mix["HMMA"]:
        fail(f"{name}_bwd: no HMMA in its chunk kernel's SASS")
    return dict(hmma=mix["HMMA"], instructions=sum(mix.values()))


def time_scan_bwd(timed):
    """Phase 12.4: each backward kernel at the training shape beside its
    bound, its plain version and the forward with and without its chunk
    states: saving the states costs the forward (with - without) and one
    layer's states of memory while remat recomputes that layer; computing
    them again in the backward would cost the forward with states once
    more. The bound reads every input of the gradient once (x, the
    decays' and products' operands, dy; not the chunk states, which the
    design chooses to keep: their read is printed apart, `states_read_ms`)
    and writes every gradient once; its flops are the stepwise backward's
    own, 10 per state element per step (the state gradient's update,
    G B or K v, G^T x or K^T k, S^T dy, <G, S>: one multiply-add each),
    plus one per decay, in 3xTF32 units at 495 TFLOP/s as phase 6
    bounds the forwards (and at the f32 rate, `bound_f32_ms`). No PyTorch
    call computes these functions (`library_ms` null)."""
    rows = {}
    for name, (args, s0, states, dy) in timed.items():
        fwd, bwd, plain, _ = _scan_fns(name)
        x = args[0]
        T = x.shape[1]
        ms, eager = time_ms([lambda: bwd(*args, states, dy)], n=6)
        fwd_ms = time_ms([lambda: fwd(*args, None)], n=12)[0]
        fwd_states_ms = time_ms([lambda: fwd(*args, None, with_states=True)],
                                n=12)[0]
        plain_ms = _event_ms(lambda: plain(*args, None, dy), 1)
        n_in = (sum(a.numel() * a.element_size() for a in args)
                + dy.numel() * dy.element_size())
        states_read_ms = (states.numel() * states.element_size()
                          / PEAK_BYTES * 1e3)
        n_out = (sum(a.numel() * a.element_size() for a in args)
                 + s0.numel() * 4)
        decays = args[3].numel() if name == "ssm_scan" else x.numel()
        flops = 10.0 * T * s0.numel() + decays
        b, by = bound(n_in + n_out, 3 * flops, PEAK_TF32_FLOPS)
        bytes_ms = bound(n_in + n_out, 0.0)[0]
        row = dict(ms=ms, eager_ms=eager, plain_ms=plain_ms, bound_ms=b,
                   bound_by=by, bound_peak="3xTF32 at 495 TFLOP/s",
                   bound_bytes_ms=bytes_ms,
                   bound_f32_ms=bound(n_in + n_out, flops,
                                      PEAK_F32_FLOPS)[0],
                   library_ms=None, fwd_ms=fwd_ms,
                   fwd_with_states_ms=fwd_states_ms,
                   chunk_states_gib=states.numel() * 4 / 2 ** 30,
                   states_read_ms=states_read_ms,
                   shape="x".join(str(n) for n in x.shape) + " f32, from "
                         "zeros")
        row["sass"] = bwd_sass(name)
        print(f"  {name}_bwd [{row['shape']}]: {ms:.4f} ms (the first, "
              f"scalar kernel, from PERF.md: "
              f"{BWD_BEFORE_REDESIGN_MS[name]:.4f} ms) (eager "
              f"{eager:.4f}), bound {b:.4f} ms ({by}; {100 * b / ms:.1f}% "
              f"of it; bytes alone {bytes_ms:.4f} ms; at the f32 rate "
              f"{row['bound_f32_ms']:.4f} ms), plain "
              f"{plain_ms:.1f} ms, library none; forward {fwd_ms:.4f} ms, "
              f"with chunk states {fwd_states_ms:.4f} ms "
              f"({row['chunk_states_gib']:.2f} GiB of states, read once "
              f"at 3.35 TB/s: {states_read_ms:.4f} ms)", flush=True)
        rows[name] = row
    return rows


def train_recurrent(dev=None, seed: int = 0) -> dict:
    """Phase 12: train the recurrent models on the card. Returns
    {"training_recurrent": ..., "rows": the kernel table's two backward
    rows}; fails on any check."""
    dev = dev or torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase("12. train recurrent: the scans' backward vs their plain versions")
    errs, timed_inputs = check_scan_bwd(dev, seed)
    phase("12. train recurrent: full-width train steps, kernels vs plain")
    ops = kernel_ops()
    steps = {}
    for arch, n_layers in RECURRENT_STEP.items():
        for op in ops.values():
            op.launches = 0
        steps[arch] = check_train_step(dev, seed, arch, n_layers, STEP_B,
                                       STEP_T)
        steps[arch]["kernel_launches"] = {k: op.launches
                                          for k, op in ops.items()
                                          if op.launches}
        print(f"  kernel launches in the four steps: "
              f"{steps[arch]['kernel_launches']}", flush=True)
        want = (("ssm_scan", "ssm_scan_bwd") if arch == "zamba2-7b"
                else ("rwkv6_wkv", "rwkv6_wkv_bwd"))
        if not all(steps[arch]["kernel_launches"].get(k) for k in want):
            fail(f"{arch}: the kernel path's train step did not launch "
                 f"{want}")
    runs = {}
    for arch in RECURRENT_TRAIN:
        phase(f"12. train {arch} on the card")
        runs[arch] = train_recurrent_on_card(arch, dev, seed)
    phase("12. train recurrent: kernel times")
    timed = time_scan_bwd(timed_inputs)
    del timed_inputs
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"  phase 12 took {wall:.1f}s", flush=True)
    rows = []
    for name, arch in (("ssm_scan", "zamba2-7b"), ("rwkv6_wkv", "rwkv6-7b")):
        n = runs[arch]["launches"][f"{name}_bwd"]
        rows.append(dict(
            name=f"{name}_bwd", route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}_bwd.cu",
            replaces=SOURCES[name],
            replaces_note=f"the backward of the {name} kernel; the "
                          f"reference differentiates its XLA scan instead",
            launches=n, launches_by_path={recurrent_path(arch): n},
            max_abs_err=errs[name, "f32_abs"],
            f32_max_rel_err=errs[name, "f32"],
            bf16_max_row_rel_err=errs[name, "bf16"], **timed[name]))
    return dict(training_recurrent=dict(
        runs=runs, train_step_checks=steps, wall_s=wall,
        scan_bwd_errors={f"{k[0]} {k[1]}": v for k, v in errs.items()},
        times=timed), rows=rows)

# Phase 13: the distribution layer on a one-device mesh. The served batch's
# shape (8 prompts of 999 tokens, 32 decode steps), and the pipeline's 4
# microbatches of B 2 x T 256.
SHARD_B, SHARD_T, SHARD_STEPS = 8, max(PROMPT_LENS), NEW_TOKENS
PIPE_MICRO, PIPE_B, PIPE_T = 4, 2, 256
SHARDED_PATH = f"{ARCH} sharded (one-device mesh)"
SEQ_SHARDED_PATH = f"{ARCH} seq-sharded prefill (one-device mesh)"
PIPE_PATH = f"{ARCH} pipeline (1 stage, {PIPE_MICRO} microbatches)"


def plan_cli_tpu() -> dict:
    """Phase 13.1: `launch.plan` with `--tiers tpu` for agh and gh into a
    temporary --out: every pair on a TPU_TIERS tier, one unmet entry per
    query type, the printed JSON the written one."""
    import io
    import tempfile

    from repro_torch.core import default_instance
    from repro_torch.core.bridge import TPU_TIERS
    from repro_torch.launch import plan as plan_cli

    names, I = {t[0] for t in TPU_TIERS}, default_instance().I
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        for method in ("agh", "gh"):
            path, buf = Path(d) / f"{method}.json", io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = plan_cli.main(["--method", method, "--tiers", "tpu",
                                    "--out", str(path)])
            host_s = time.perf_counter() - t0
            res = json.loads(path.read_text())
            tiers = sorted({p["tier"] for p in res["pairs"]})
            if rc or json.loads(buf.getvalue()) != res:
                fail(f"plan --method {method} --tiers tpu: exit {rc} or its "
                     f"printed JSON is not its --out file")
            if not tiers or not set(tiers) <= names:
                fail(f"plan --tiers tpu placed pairs on {tiers}")
            if len(res["unmet"]) != I:
                fail(f"plan --tiers tpu: {len(res['unmet'])} unmet "
                     f"entries for {I} query types")
            print(f"  {method} --tiers tpu: objective {res['objective']}, "
                  f"stage-1 cost {res['stage1_cost']}, {len(res['pairs'])} "
                  f"pairs on {tiers}; {host_s:.3f} s on the host (solver "
                  f"{res['runtime_s']} s)", flush=True)
            out[method] = dict(objective=res["objective"],
                               stage1_cost=res["stage1_cost"],
                               pairs=len(res["pairs"]), tiers=tiers,
                               host_s=host_s, solver_s=res["runtime_s"])
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _whole(t):
    from repro_torch.device import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def decode_run(params, cfg, toks, dec, dev) -> tuple:
    """Prefill toks, then one decode step per column of dec, on the
    kernels, with every launch count set to 0 just before and read just
    after. Returns (logits [B, 1 + steps, V] f32, wall s, launches)."""
    from repro_torch.models import decoder
    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
    T, n = toks.shape[1], dec.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        lg, cache = decoder.prefill(params, cfg, toks, max_len=T + n)
        out = [_whole(lg)]
        for s in range(n):
            lg, cache = decoder.decode_step(params, cfg, cache,
                                            dec[:, s:s + 1], T + s)
            out.append(_whole(lg))
    _sync(dev)
    wall = time.perf_counter() - t0
    got = torch.cat(out, dim=1).float()
    if not torch.isfinite(got).all():
        fail(f"non-finite logits ({cfg.dtype}, "
             f"seq_shard_attention={cfg.seq_shard_attention})")
    return got, wall, {k: op.launches for k, op in ops.items()
                       if op.launches}


def sharded_paths(params, cfg, mesh, dev, seed) -> dict:
    """Phases 13.2-13.3: the served batch's prefill and decode steps on the
    parameters made DTensors by `distribute_params` (the cache placed by
    `cache_specs`), without and with `seq_shard_attention`, against the
    unsharded kernel path of the same weights under phase 5's bf16
    criteria (the f32 logits of the same bf16-rounded weights, unsharded,
    are the truth). Both attention kernels must launch as often as on the
    unsharded path."""
    from repro_torch.parallel.sharding import distribute_params
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    toks = torch.randint(1, cfg.vocab_size, (SHARD_B, SHARD_T),
                         generator=gen, device=dev)
    dec = torch.randint(1, cfg.vocab_size, (SHARD_B, SHARD_STEPS),
                        generator=gen, device=dev)
    decode_run(params, cfg, toks[:, :64], dec[:, :2], dev)  # warm-up
    want, wall0, n0 = decode_run(params, cfg, toks, dec, dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32 = decode_run(_tree_map(lambda x: x.float(), params), cfg32, toks,
                     dec, dev)[0]
    rel0 = row_rel(want, f32)
    print(f"  unsharded: {wall0:.3f} s, launches {n0}; vs the f32 logits "
          f"{rel0:.3e}", flush=True)
    sp = distribute_params(params, mesh)
    out = dict(unsharded=dict(wall_s=wall0, launches=n0, f32_row_rel=rel0))
    for label, c, path in (
            ("sharded", cfg, SHARDED_PATH),
            ("seq_sharded", dataclasses.replace(cfg,
                                                seq_shard_attention=True),
             SEQ_SHARDED_PATH)):
        phase(f"13.{2 if label == 'sharded' else 3} {path}")
        decode_run(sp, c, toks[:, :64], dec[:, :2], dev)     # warm-up
        got, wall, n = decode_run(sp, c, toks, dec, dev)
        err = (got - want).abs().max().item()
        rel, rel_f32 = row_rel(got, want), row_rel(got, f32)
        same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        ok = rel <= E2E_BF16_REL and rel_f32 <= 2 * rel0 + E2E_TOL
        print(f"  {label}: {wall:.3f} s (unsharded {wall0:.3f} s), "
              f"launches {n}; logits vs the unsharded kernel path: max abs "
              f"diff {err:.3e}, max_row_rel_err {rel:.3e} (tol "
              f"{E2E_BF16_REL:g}), vs f32 {rel_f32:.3e} (tol 2x "
              f"{rel0:.3e} + {E2E_TOL:g}); same greedy token in "
              f"{same:.3f} of rows {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"{label} logits disagree with the unsharded kernel path")
        for k in ("flash_attention", "decode_attention"):
            if not n.get(k) or n.get(k) != n0.get(k):
                fail(f"{label}: {k} launched {n.get(k, 0)} times, the "
                     f"unsharded path {n0.get(k, 0)}")
        out[label] = dict(path=path, wall_s=wall, launches=n,
                          max_abs_diff=err, max_row_rel_err=rel,
                          f32_row_rel=rel_f32, same_greedy=same)
    return out


def pipeline_one_stage(params, cfg, dev, seed) -> dict:
    """Phase 13.4: `pipelined_forward` over the layer stack split into one
    stage ("stage" mesh of the one device), 4 microbatches of B 2 x T 256,
    each stage running the decoder's layer body on the kernels: bit for
    bit the sequential run; flash_attention launched once per layer per
    microbatch."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import decoder
    from repro_torch.parallel.pipeline import (pipelined_forward,
                                               split_stages)
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("stage",))
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    toks = torch.randint(1, cfg.vocab_size, (PIPE_MICRO, PIPE_B, PIPE_T),
                         generator=gen, device=dev)

    def stage_fn(sp, x):
        for i in range(sp["ln1"].shape[0]):
            x = decoder._train_layer(decoder._layer(sp, i), cfg, x, True)
        return x

    ops = kernel_ops()
    with torch.no_grad():
        xs = torch.stack([decoder._embed(params, cfg, toks[m], None)
                          for m in range(PIPE_MICRO)])
        run = pipelined_forward(stage_fn, mesh, 1, PIPE_MICRO)
        stages = split_stages(params["layers"], 1)
        run(stages, xs)                                      # warm-up
        for op in ops.values():
            op.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        got = run(stages, xs)
        _sync(dev)
        wall = time.perf_counter() - t0
        n = {k: op.launches for k, op in ops.items() if op.launches}
        t0 = time.perf_counter()
        want = torch.stack([stage_fn(params["layers"], xs[m])
                            for m in range(PIPE_MICRO)])
        _sync(dev)
        wall_seq = time.perf_counter() - t0
    same = torch.equal(got, want)
    print(f"  {PIPE_PATH}: {wall:.3f} s (sequential {wall_seq:.3f} s), "
          f"launches {n}; bit for bit the sequential run: {same}",
          flush=True)
    if not same:
        fail("the one-stage pipeline differs from the sequential run")
    if n.get("flash_attention") != cfg.n_layers * PIPE_MICRO:
        fail(f"the pipeline launched flash_attention "
             f"{n.get('flash_attention', 0)} times, not "
             f"{cfg.n_layers * PIPE_MICRO}")
    return dict(path=PIPE_PATH, wall_s=wall, sequential_wall_s=wall_seq,
                launches=n, bitwise_equal=same)


def shard_and_pipeline(dev=None, seed: int = 0) -> dict:
    """Phase 13: the planning CLI on the TPU catalog, then, on a
    one-process NCCL group (a HashStore: no port, no network), the sharded
    main path, the context-parallel prefill and the one-stage pipeline of
    full-width qwen2-0.5b in bf16. Returns the phase's numbers; fails on
    any check."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decoder

    dev = dev or torch.device("cuda")
    t0 = time.perf_counter()
    phase("13.1 the planning CLI on the TPU tier catalog")
    out = dict(plan_cli=plan_cli_tpu())
    phase("13.2 the sharded main path on a one-device NCCL mesh")
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1)
        cfg = get_config(ARCH)
        params = decoder.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
        out.update(sharded_paths(params, cfg, mesh, dev, seed))
        phase(f"13.4 {PIPE_PATH}")
        out["pipeline"] = pipeline_one_stage(params, cfg, dev, seed)
        del params
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 13 took {out['wall_s']:.1f}s", flush=True)
    return out


# Phase 14: the MoE, RWKV6 and Mamba2 mixers on a one-device mesh, then the
# dry-run on fake process groups. The served models: (label, arch, config
# fields replaced, kernels the path must launch, f32 logits check too), at
# phase 5's and phase 10's depths. kimi-k2's f32 weights do not fit: bf16
# only, as in phase 10.
MIXER_MODELS = (
    ("rwkv6-7b (4 layers)", "rwkv6-7b", dict(n_layers=4), ("rwkv6_wkv",),
     True),
    ("zamba2-7b (7 layers)", "zamba2-7b", dict(n_layers=7),
     ("ssm_scan", "flash_attention", "decode_attention"), True),
    ("kimi-k2 (1 layer)", "kimi-k2-1t-a32b", dict(n_layers=1),
     ("flash_attention", "decode_attention"), False),
    ("kimi-k2 W8A8 (2 layers)", "kimi-k2-1t-a32b",
     dict(n_layers=2, moe_w8a8=True),
     ("flash_attention", "decode_attention", INT8_WGMMA), False),
)
# 14.3: one training step at the same depths, batch B x T, on the mesh.
MIXER_TRAIN = {"rwkv6-7b": 4, "zamba2-7b": 7}
MIXER_TRAIN_B, MIXER_TRAIN_T = 2, 512
# 14.4: the dry-runs (arch, shape, multi-pod), each in a subprocess of its
# own with a fake process group of 256 or 512 ranks, started when the phase
# starts and read at its end.
DRYRUNS = (("qwen2-72b", "train_4k", False),
           ("kimi-k2-1t-a32b", "decode_32k", True))
# Rows per device before a change, printed beside this run's (flops,
# collective bytes, what the step did then; PERF.md section 6): constants,
# kept out of the JSON lines. kimi-k2 decode_32k while each "model" rank
# gathered the whole KV cache and attended over all of it; qwen2-72b
# train_4k while every rank looked up the whole batch's embeddings and the
# table's gradient was all-reduced whole, as this phase printed it under
# torch 2.11 (torch 2.13's DTensor counted 8.5017e11 collective bytes).
DRYRUN_BEFORE = {
    ("kimi-k2-1t-a32b", "decode_32k", True):
        (8.489e10, 9.265e9, "each model rank gathered the whole KV cache"),
    ("qwen2-72b", "train_4k", False):
        (5.6573e15, 8.6535e11, "every rank looked up the whole batch and "
                               "the table's gradient was all-reduced "
                               "whole")}
# 14.5: the slot-split decode on one card at kimi-k2's per-rank decode_32k
# shape on 2x16x16: batch 128 over the 32 (pod, data) ranks, 8 KV heads of
# G 8 at hd 128, the 8,192-slot window's ring cut into the 16 "model"
# ranks' ranges; a late decode position (every range full) and an early
# one (ranges 2-15 empty).
SLOT_DECODE = dict(B=4, KV=8, G=8, hd=128, S=8192, n=16)
SLOT_DECODE_POS = (3 * 8192 + 123, 1000)
INT8_NMAJOR = "int8_grouped_matmul_nmajor"


def mixer_path(label: str) -> str:
    return f"{label} sharded (one-device mesh)"


def counted(fn):
    """fn() with every kernel's launch count set to 0 just before and read
    just after; the int8 GEMM's split by kernel (K-major wgmma, N-major)."""
    from repro_torch.kernels.int8_grouped_matmul.ops import \
        int8_grouped_matmul
    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
    int8_grouped_matmul.wgmma_launches = 0
    out = fn()
    n = {k: op.launches for k, op in ops.items() if op.launches}
    w = int8_grouped_matmul.wgmma_launches
    n.pop("int8_grouped_matmul", None)
    if w:
        n[INT8_WGMMA] = w
    if ops["int8_grouped_matmul"].launches - w:
        n[INT8_NMAJOR] = ops["int8_grouped_matmul"].launches - w
    return out, n


def _pin_threads(cores: set) -> None:
    """Every thread of this process onto `cores` (threads made later
    inherit the mask of the thread that makes them)."""
    import os
    for tid in os.listdir("/proc/self/task"):
        with contextlib.suppress(ProcessLookupError):
            os.sched_setaffinity(int(tid), cores)


def start_dryruns() -> list:
    """Phase 14.4's subprocesses, on the host only (no card); any still
    running when this process exits, on a failed check too, is killed.
    Each trace runs on a core of its own, one thread, at the lowest
    priority, and this process keeps off those cores until they end
    (`stop_dryruns`): the walls of phases 10-14, taken on the host's
    clock meanwhile, never share a core with a trace."""
    import atexit
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < len(DRYRUNS) + 2:
        fail(f"the dry-runs need {len(DRYRUNS)} cores of their own beside "
             f"two for this process; it may run on {len(cores)}")
    theirs, mine = cores[-len(DRYRUNS):], set(cores[:-len(DRYRUNS)])
    procs = []
    for (arch, shape, multi), core in zip(DRYRUNS, theirs, strict=True):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + (["--multi-pod"] if multi else [])

        def pin(core=core):
            os.nice(19)
            os.sched_setaffinity(0, {core})
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      env=env, cwd=ROOT, preexec_fn=pin))
    _DRYRUN_HOST.update(cores=set(cores), threads=torch.get_num_threads())
    _pin_threads(mine)
    torch.set_num_threads(len(mine))
    print(f"  dry-runs on cores {theirs}, this process on {sorted(mine)}",
          flush=True)
    atexit.register(stop_dryruns, procs)
    return procs


# the cores and intra-op threads this process had before the dry-runs
_DRYRUN_HOST: dict = {}


def stop_dryruns(procs) -> None:
    """Kill the dry-runs still running; this process gets its cores
    back."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if _DRYRUN_HOST:
        _pin_threads(_DRYRUN_HOST["cores"])
        torch.set_num_threads(_DRYRUN_HOST["threads"])
        _DRYRUN_HOST.clear()


def finish_dryruns(procs, t0) -> list:
    """Phase 14.4: wait for the dry-runs, print each row's counts and its
    roofline line (H100 data-sheet constants: counts from a meta trace,
    not times); fails unless every row is `status: ok`."""
    from repro_torch.analysis import roofline
    rows = []
    for (arch, shape, multi), proc in zip(DRYRUNS, procs, strict=True):
        out, err = proc.communicate(timeout=900)
        if proc.returncode:
            fail(f"dry-run {arch} {shape} exited {proc.returncode}: "
                 f"{err[-2000:]}")
        r = json.loads(out)
        if r.get("status") != "ok":
            fail(f"dry-run {arch} {shape}: status {r.get('status')}")
        a = roofline.analyze_row(r)
        print(f"  dry-run {arch} {shape} {'2x16x16' if multi else '16x16'}:"
              f" {r['n_devices']} fake ranks, status {r['status']}, trace "
              f"{r['lower_s']} s; per device {r['hlo_flops_per_device']:.4e}"
              f" flops, {r['hlo_bytes_per_device']:.4e} bytes (estimate), "
              f"{r['collective_bytes_per_device']:.4e} collective bytes "
              f"{r['collectives']}; global flops "
              f"{r['raw_cost_analysis_flops']:.4e}; memory {r['memory']}",
              flush=True)
        print("  " + roofline.markdown_table([a]).splitlines()[-1],
              flush=True)
        before = DRYRUN_BEFORE.get((arch, shape, multi))
        if before:
            print(f"  {arch} {shape}: {r['hlo_flops_per_device']:.4e} flops"
                  f" and {r['collective_bytes_per_device']:.4e} collective "
                  f"bytes per device, {before[0]:.4e} and {before[1]:.4e} "
                  f"when {before[2]}", flush=True)
        rows.append(dict(row=r, roofline={k: v for k, v in a.items()
                                          if k != "collectives"}))
    print(f"  the dry-runs ended {time.perf_counter() - t0:.1f}s after "
          f"they started", flush=True)
    return rows


def serve_mixer(mesh, dev, seed, label, arch, replace, kernels, f32) -> dict:
    """Phases 14.1-14.2 for one model: the served batch's prefill and 32
    decode steps on the unsharded kernel path, then on the same weights
    made DTensors by `distribute_params` (sharing their storage) with a
    DTensor cache; logits under phase 5's bf16 criteria (f32 truth where
    it fits), launches equal, no N-major int8 launch; peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    from repro_torch.parallel.sharding import distribute_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), **replace)
    params = decoder.init_params(torch.Generator(device=dev).manual_seed(seed),
                                 cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    toks = torch.randint(1, cfg.vocab_size, (SHARD_B, SHARD_T),
                         generator=gen, device=dev)
    dec = torch.randint(1, cfg.vocab_size, (SHARD_B, SHARD_STEPS),
                        generator=gen, device=dev)
    sp = distribute_params(params, mesh)
    shared = all(a.to_local().data_ptr() == b.data_ptr()
                 for a, b in zip(_leaves(sp), _leaves(params), strict=True))
    if not shared:
        fail(f"{label}: the DTensor tree copied the weights")
    runs = {}
    for name, ps in (("unsharded", params), ("sharded", sp)):
        decode_run(ps, cfg, toks[:, :64], dec[:, :2], dev)     # warm-up
        (got, wall, _), n = counted(lambda ps=ps: decode_run(ps, cfg, toks,
                                                             dec, dev))
        runs[name] = (got, wall, n)
    (want, wall0, n0), (got, wall, n) = runs["unsharded"], runs["sharded"]
    err = (got - want).abs().max().item()
    rel = row_rel(got, want)
    ok, rel_f32, rel0 = rel <= E2E_BF16_REL, None, None
    if f32:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        truth = decode_run(_tree_map(lambda x: x.float(), params), cfg32,
                           toks, dec, dev)[0]
        rel0, rel_f32 = row_rel(want, truth), row_rel(got, truth)
        ok = ok and rel_f32 <= 2 * rel0 + E2E_TOL
        del truth
    same = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {label}: sharded {wall:.3f} s, unsharded {wall0:.3f} s "
          f"({wall / wall0:.2f}x); launches sharded {n}, unsharded {n0}; "
          f"logits vs the unsharded kernel path: max abs diff {err:.3e}, "
          f"max_row_rel_err {rel:.3e} (tol {E2E_BF16_REL:g})"
          + ("" if rel_f32 is None else
             f", vs f32 {rel_f32:.3e} (tol 2x {rel0:.3e} + {E2E_TOL:g})")
          + f"; same greedy token in {same:.3f} of rows; weights shared "
          f"with the unsharded tree: {shared}; peak {peak:.2f} GiB "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail(f"{label}: sharded logits disagree with the unsharded path")
    for k in kernels:
        if not n.get(k) or n.get(k) != n0.get(k):
            fail(f"{label}: {k} launched {n.get(k, 0)} times sharded, "
                 f"{n0.get(k, 0)} unsharded")
    if n != n0 or n.get(INT8_NMAJOR) or n0.get(INT8_NMAJOR):
        fail(f"{label}: launches differ or reach the N-major int8 kernel: "
             f"{n} vs {n0}")
    del params, sp, runs, got, want
    torch.cuda.empty_cache()
    return dict(path=mixer_path(label), wall_s=wall, unsharded_wall_s=wall0,
                launches=n, unsharded_launches=n0, max_abs_diff=err,
                max_row_rel_err=rel, f32_row_rel=rel_f32,
                unsharded_f32_row_rel=rel0, same_greedy=same,
                weights_shared=shared, peak_gib=peak)


def train_mixer(mesh, dev, seed, arch, n_layers) -> dict:
    """Phase 14.3: one bf16 training step of `arch` at `n_layers` on the
    mesh and unsharded, kernels both: every gradient leaf under phase 12's
    bf16 criterion (rel L2 to the f32 gradient of the same bf16-rounded
    weights, the plain path's, at most 2x the plain bf16 path's +
    E2E_TOL), the sharded-vs-unsharded gap printed, the scans and their
    backwards launched as often."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    from repro_torch.parallel.sharding import distribute_params
    from repro_torch.training.data import DataConfig, PackedStream
    from repro_torch.training.train_loop import batch_on
    torch.cuda.empty_cache()
    cfg16 = dataclasses.replace(get_config(arch), n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    params = decoder.init_params(torch.Generator(device=dev).manual_seed(seed),
                                 cfg16)
    batch = batch_on(PackedStream(DataConfig(
        vocab_size=cfg16.vocab_size, seq_len=MIXER_TRAIN_T,
        batch_size=MIXER_TRAIN_B, seed=0)).batch(0), dev)
    names = [n for n, _ in sorted(_named(params))]
    _sync(dev)
    t0 = time.perf_counter()
    (lk, gk), n0 = counted(lambda: _grads(params, cfg16, batch, True))
    _sync(dev)
    wall0 = time.perf_counter() - t0
    sp = distribute_params(params, mesh)
    t0 = time.perf_counter()
    (ls, gs), n = counted(lambda: _grads(sp, cfg16, batch, True))
    gs = [_whole(g) for g in gs]
    _sync(dev)
    wall = time.perf_counter() - t0
    lp, gp = _grads(params, cfg16, batch, False)
    lt, gt = _grads(_tree_map(lambda x: x.float(), params), cfg32, batch,
                    False)
    bad, worst, gap = [], (0.0, ""), (0.0, "")
    for name, a, k, b, t in zip(names, gs, gk, gp, gt, strict=True):
        rs, rp = _rel_l2(a, t), _rel_l2(b, t)
        worst = max(worst, (rs / max(2 * rp + E2E_TOL, 1e-30), name))
        gap = max(gap, (_rel_l2(a, k), name))
        if rs > 2 * rp + E2E_TOL:
            bad.append(name)
    want = (("ssm_scan", "ssm_scan_bwd") if arch == "zamba2-7b"
            else ("rwkv6_wkv", "rwkv6_wkv_bwd"))
    print(f"  {arch} ({n_layers} layers) bf16 train step B={MIXER_TRAIN_B} "
          f"T={MIXER_TRAIN_T}: loss sharded {ls.item():.5f}, unsharded "
          f"{lk.item():.5f}, plain {lp.item():.5f}, f32 {lt.item():.5f}; "
          f"worst leaf {worst[1]} at {worst[0]:.3f} of its tol (rel L2 to "
          f"f32 <= 2x plain + {E2E_TOL:g}); sharded vs unsharded largest "
          f"rel L2 {gap[0]:.3e} ({gap[1]}); launches sharded {n}, unsharded "
          f"{n0}; {wall:.3f} s sharded, {wall0:.3f} s unsharded "
          f"{'ok' if not bad else 'MISMATCH ' + str(bad)}", flush=True)
    if bad:
        fail(f"{arch}: sharded train-step gradients too far from f32: {bad}")
    if n != n0 or not all(n.get(k) for k in want):
        fail(f"{arch}: the sharded train step launched {n}, unsharded {n0}")
    del params, sp, gs, gk, gp, gt
    torch.cuda.empty_cache()
    return dict(path=f"{arch} ({n_layers} layers) sharded train step "
                     f"(one-device mesh)",
                launches=n, unsharded_launches=n0, loss=ls.item(),
                unsharded_loss=lk.item(), worst_leaf_of_tol=worst[0],
                worst_leaf=worst[1], sharded_vs_unsharded_rel_l2=gap[0],
                wall_s=wall, unsharded_wall_s=wall0)


def slot_split_decode(dev, seed) -> dict:
    """Phase 14.5 (`SLOT_DECODE`): the decode kernel with its lse on each
    rank's slot range, the parts merged by `merge_decode_parts` over a
    stacked dim, the arithmetic that the mesh runs over its "model" dim;
    held against the kernel over the whole cache (bf16 tolerances) and
    the plain version in f32, at each of `SLOT_DECODE_POS`; each range's
    lse against its plain version's at 2e-5. Then one range's call, with
    and without the lse, the whole cache's call, and the merge, timed as
    CUDA-graph replays, beside the bytes bounds. Returns the numbers."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.layers import (decode_key_positions,
                                           merge_decode_parts)

    c = SLOT_DECODE
    B, KV, G, hd, S, n = (c[k] for k in ("B", "KV", "G", "hd", "S", "n"))
    L = S // n
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 145)
    q = torch.randn((B, KV, G, hd), generator=gen, device=dev).to(bf16)
    kc = model_layout(gen, B, S, KV, hd, bf16, dev)
    vc = model_layout(gen, B, S, KV, hd, bf16, dev)
    starts = range(0, S, L)
    out = dict(shape=f"B={B} KV={KV} G={G} hd={hd} S={S} ring, {n} ranges "
                     f"of {L} slots, bf16", positions={})
    n0 = decode_attention.launches
    for pos in SLOT_DECODE_POS:
        maps = [decode_key_positions(S, pos, S, dev, start=a, length=L)
                for a in starts]
        parts = [decode_attention(q, kc[:, :, a:a + L], vc[:, :, a:a + L],
                                  kp, pos, return_lse=True)
                 for a, kp in zip(starts, maps)]
        lse_err = 0.0
        for a, kp, (_, lse) in zip(starts, maps, parts):
            want = decode_attention_ref(
                *f32(q, kc[:, :, a:a + L], vc[:, :, a:a + L]), kp, pos,
                return_lse=True)[1]
            fin = torch.isfinite(want)
            if not (torch.equal(torch.isfinite(lse), fin) and torch.allclose(
                    lse[fin], want[fin], atol=F32_TOL, rtol=F32_TOL)):
                fail(f"14.5 pos {pos}: range {a}'s lse disagrees with its "
                     f"plain version's")
            if fin.any():
                lse_err = max(lse_err, (lse[fin] - want[fin]).abs().max()
                              .item())
        empty = sum(bool(torch.isneginf(lse).all()) for _, lse in parts)
        zero = all(bool((o == 0).all()) for o, lse in parts
                   if bool(torch.isneginf(lse).all()))
        if empty != max(S - pos - 1, 0) // L:
            fail(f"14.5 pos {pos}: {empty} empty ranges")
        merged = merge_decode_parts(torch.stack([o for o, _ in parts]),
                                    torch.stack([lse for _, lse in parts]),
                                    dim=0)
        if torch.isnan(merged).any() or not zero:
            fail(f"14.5 pos {pos}: NaN in the merge, or an empty range "
                 f"whose output is not zero")
        k_pos = decode_key_positions(S, pos, S, dev)
        whole = decode_attention(q, kc, vc, k_pos, pos)
        plain = decode_attention_ref(*f32(q, kc, vc), k_pos, pos)
        err_whole, rel_whole = check_kernel(
            f"14.5 merged vs the whole-cache kernel, pos {pos}",
            merged.to(bf16), whole.float())
        err_plain, rel_plain = check_kernel(
            f"14.5 merged vs the plain version (f32), pos {pos}",
            merged.to(bf16), plain)
        out["positions"][str(pos)] = dict(
            empty_ranges=empty, max_abs_err_vs_whole_kernel=err_whole,
            row_rel_vs_whole_kernel=rel_whole,
            max_abs_err_vs_plain=err_plain, row_rel_vs_plain=rel_plain,
            range_lse_max_abs_err=lse_err)
        print(f"  pos {pos}: {empty} of {n} ranges empty, range lse within "
              f"{lse_err:.3e} of the plain version's", flush=True)
    out["check_launches"] = decode_attention.launches - n0

    # Times at the late position: every slot admissible, so the bounds
    # are the ranges' and the whole cache's bytes.
    pos = SLOT_DECODE_POS[0]
    maps = [decode_key_positions(S, pos, S, dev, start=a, length=L)
            for a in starts]
    k_pos = decode_key_positions(S, pos, S, dev)
    ranges = [(kc[:, :, a:a + L], vc[:, :, a:a + L], kp)
              for a, kp in zip(starts, maps)]
    item = q.element_size()

    def range_bound(slots):
        return bound(item * (2 * q.numel() + 2 * B * KV * slots * hd)
                     + 4 * slots + (4 * B * KV * G), 4.0 * B * KV * G * hd
                     * slots)
    range_ms = time_ms([lambda r=r: dk.decode_attention(
        q, *r, pos, return_lse=True) for r in ranges])[0]
    range_plain_ms = time_ms([lambda r=r: dk.decode_attention(q, *r, pos)
                              for r in ranges])[0]
    whole_ms = time_ms([lambda: dk.decode_attention(q, kc, vc, k_pos,
                                                    pos)])[0]
    o_parts = torch.stack([p[0] for p in parts])
    l_parts = torch.stack([p[1] for p in parts])
    merge_ms = time_ms([lambda: merge_decode_parts(o_parts, l_parts,
                                                   dim=0)])[0]
    rb, rby = range_bound(L)
    wb, wby = range_bound(S)
    out.update(range_ms=range_ms, range_no_lse_ms=range_plain_ms,
               range_bound_ms=rb, range_bound_by=rby, whole_ms=whole_ms,
               whole_bound_ms=wb, whole_bound_by=wby,
               merge_of_stacked_parts_ms=merge_ms,
               range_cache_mb=2 * B * KV * L * hd * item / 1e6,
               whole_cache_mb=2 * B * KV * S * hd * item / 1e6)
    print(f"  one range ({L} slots, {out['range_cache_mb']:.1f} MB): "
          f"{range_ms:.4f} ms with the lse, {range_plain_ms:.4f} ms without "
          f"(bound {rb:.4f} ms, {rby}); the whole cache ({S} slots, "
          f"{out['whole_cache_mb']:.1f} MB, what each model rank ran while "
          f"the cache was gathered): {whole_ms:.4f} ms (bound {wb:.4f} ms, "
          f"{wby}); the merge of {n} stacked parts on one card "
          f"{merge_ms:.4f} ms", flush=True)
    return out


def mixers_under_a_mesh(dev=None, seed: int = 0, dryruns=None) -> dict:
    """Phase 14: the MoE, RWKV6 and Mamba2 mixers on DTensors on a
    one-process NCCL group and a one-device mesh (serving, memory,
    training), with the dry-runs in subprocesses meanwhile: `dryruns`
    (procs, their start time) when the caller started them earlier, else
    started here. Returns the phase's numbers; fails on any check."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dev = dev or torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if dryruns is None:
        phase("14.4 the dry-runs start (subprocesses, fake process groups)")
        dryruns = start_dryruns(), t0
    procs, started = dryruns
    out = dict(serving={}, training={})
    try:
        torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            mesh = make_host_mesh(1)
            for label, arch, replace, kernels, f32 in MIXER_MODELS:
                phase(f"14.1-14.2 {mixer_path(label)}")
                out["serving"][label] = serve_mixer(
                    mesh, dev, seed, label, arch, replace, kernels, f32)
            for arch, n_layers in MIXER_TRAIN.items():
                phase(f"14.3 train {arch} on the mesh")
                out["training"][arch] = train_mixer(mesh, dev, seed, arch,
                                                    n_layers)
        finally:
            dist.destroy_process_group()
        phase("14.5 the slot-split decode: kernel with lse per slot range, "
              "merged")
        out["slot_decode"] = slot_split_decode(dev, seed)
        phase("14.4 the dry-runs")
        out["dryrun"] = finish_dryruns(procs, started)
    finally:
        stop_dryruns(procs)
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 14 took {out['wall_s']:.1f}s", flush=True)
    return out


# Phase 15: the example drivers' twins, each run as a user would run it
# (default flags; the train twin at 50 steps, the rolling replay at the
# reference CI's 16 windows), and the kernels each path must launch (the
# quickstart's torch tier and the numpy replay launch none of them).
EXAMPLES = {
    "serve_e2e_torch": ((), ("flash_attention", "decode_attention")),
    "train_demo_torch": (("--steps", "50"),
                         ("flash_attention", "flash_attention_bwd")),
    "quickstart_torch": ((), ()),
    "rolling_replay_torch": (("--windows", "16"), ()),
}


def example_path(name: str) -> str:
    return f"examples/{name}.py"


def _expected_plan_lines() -> list[str]:
    """The serve twin's [plan] pair lines as this process's planner gives
    them (the [plan] line's wall time aside)."""
    from repro_torch import plan
    from repro_torch.core import default_instance
    from repro_torch.core.bridge import to_deployment
    inst = default_instance()
    spec = to_deployment(inst, plan("agh", instance=inst).solution)
    return [f"[plan] AGH in <wall>s -> {len(spec.pairs)} deployed pairs",
            *(f"  {p.model} @ {p.tier} TP={p.tp} PP={p.pp} "
              f"chips={p.n_chips} routing={p.routing}" for p in spec.pairs)]


def _kernel_counts(stdout: str, name: str, kernels) -> dict:
    line = next((ln for ln in stdout.splitlines()
                 if ln.startswith("[kernels] ")), None)
    if line is None:
        fail(f"{name} printed no [kernels] line")
    counts = {k: int(v) for k, v in (kv.split("=")
                                     for kv in line.split()[1:])}
    for k in kernels:
        if counts.get(k, 0) <= 0:
            fail(f"{example_path(name)} launched no {k} kernel: {counts}")
    return counts


def _quickstart_numbers(stdout: str) -> dict:
    """The quickstart twin's AGH objective on the numpy engine and on the
    torch tier (on the card), which may only match or beat it, and the
    tier's device calls, which must be some."""
    import re
    numpy_obj = float(re.search(r"^agh: solved in \d+ ms, objective "
                                r"\$([0-9.]+)", stdout, flags=re.M).group(1))
    m = re.search(r"^agh on engine='torch': \$([0-9.]+) in (\d+) ms \((\d+)"
                  r" orderings batched, (\d+) phase-2 device calls\)",
                  stdout, flags=re.M)
    if m is None:
        fail("examples/quickstart_torch.py printed no torch-tier line")
    out = dict(numpy_objective=numpy_obj, torch_objective=float(m.group(1)),
               torch_ms=int(m.group(2)), orderings=int(m.group(3)),
               device_calls_phase2=int(m.group(4)))
    if out["torch_objective"] > numpy_obj or not out["device_calls_phase2"]:
        fail(f"the quickstart's torch tier: {out}")
    return out


def _replay_numbers(stdout: str) -> dict:
    """The rolling replay's two policies (mean and total cost a window,
    violations, replans) and the session's plans."""
    import re
    rows = {m.group(1): dict(mean=float(m.group(2)), total=float(m.group(3)),
                             viol_pct=float(m.group(4)),
                             replans=int(m.group(5)))
            for m in re.finditer(r"^(AGH-\S+)\s+([0-9.]+)\s+([0-9.]+)\s+"
                                 r"([0-9.]+)%\s+(\d+)$", stdout, flags=re.M)}
    if set(rows) != {"AGH-static", "AGH-5min"} or \
            "trace: 16 windows" not in stdout:
        fail(f"examples/rolling_replay_torch.py printed {rows}")
    return rows


def run_examples() -> dict:
    """Phase 15: the example drivers' twins on the card, each in a
    subprocess (its own counters, reset there before the run and printed
    after). Returns the phase's numbers; fails on any check."""
    import os
    import re
    import shutil
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ckpt = ROOT / "build" / "train_demo_torch"
    out = {}
    try:
        for name, (args, kernels) in EXAMPLES.items():
            phase(f"15. {example_path(name)} on the card")
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, str(ROOT / example_path(name)), *args],
                capture_output=True, text=True, cwd=ROOT, env=env,
                timeout=300)
            wall = time.perf_counter() - t0
            for line in p.stdout.splitlines():
                print(f"  | {line}")
            if p.returncode:
                fail(f"{example_path(name)} exited {p.returncode}:\n"
                     f"{p.stderr[-4000:]}")
            run = dict(wall_s=wall, launches=_kernel_counts(
                p.stdout, name, kernels) if kernels else {})
            if name == "quickstart_torch":
                run.update(_quickstart_numbers(p.stdout))
            elif name == "rolling_replay_torch":
                run.update(_replay_numbers(p.stdout))
            elif name == "serve_e2e_torch":
                lines = p.stdout.splitlines()
                at = next(i for i, ln in enumerate(lines)
                          if ln.startswith("[plan]"))
                want = _expected_plan_lines()
                got = [re.sub(r"AGH in [0-9.]+s", "AGH in <wall>s",
                              lines[at]), *lines[at + 1:at + len(want)]]
                if got != want:
                    fail(f"plan lines {got} are not the planner's {want}")
                served = re.search(r"\[serve\] (\d+) requests, (\d+) "
                                   r"tokens in ([0-9.]+)s \(([0-9.]+) tok/s",
                                   p.stdout)
                run.update(pairs=len(want) - 1,
                           tokens=int(served.group(2)),
                           serve_s=float(served.group(3)),
                           tok_s=float(served.group(4)),
                           ttft_p50_ms={m.group(1): float(m.group(2))
                                        for m in re.finditer(
                                            r"^  (\S+)\s+TTFT p50=\s*"
                                            r"([0-9.]+)ms", p.stdout,
                                            flags=re.M)})
            elif name == "train_demo_torch":
                m = re.search(r"loss: ([0-9.]+) -> ([0-9.]+) over (\d+) "
                              r"steps", p.stdout)
                run.update(loss_first=float(m.group(1)),
                           loss_last=float(m.group(2)),
                           steps=int(m.group(3)))
                if not run["loss_last"] < run["loss_first"]:
                    fail(f"train twin's loss did not fall: {run}")
            print(f"  {name}: rc 0, {wall:.1f} s, launches "
                  f"{run['launches']}")
            out[name] = run
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


# Phase 16: the configurations that had run their paths only on the CPU,
# at published widths. 16.1 serves the three dense ones through the
# launcher's engine (phase 4's batch, phases 5 and 7 for each); depth cut
# where the weights would not fit beside the cache: None = whole.
DENSE_SERVED = {"deepseek-7b": None, "qwen2-1.5b": None, "qwen2-72b": 16}
DENSE_LOGITS_LAYERS = 2
# Both attention kernels at their served shapes: hd 128 at G 1 (deepseek's
# MHA), G 6 and G 8, no window.
DENSE_ATTENTION = tuple((arch, arch, 0) for arch in DENSE_SERVED)
# 16.2 trains the MoE, prefix and codebook families, 10 steps each through
# the launcher's `train`, each in a process of its own (`family_steps`):
# its peak is then the configuration's, not the allocator history's of
# 15 phases. (depth, B, prefix rows, T tokens after them, the vocabulary;
# None = published). The port's AdamW updates in place (the reference's
# donated buffers): a step holds 12 B a parameter (bf16 weight and
# gradient, f32 mu and nu) plus an update piece's or the global norm's
# temporaries (`reckon_train_peak`), so llama4-scout's one full-width
# layer trains its whole 202,048-word vocabulary (4.27e9 parameters, ~54
# GiB reckoned; an update that built new weights and moments beside the
# old held ~22 B a parameter, ~123 GB here). internvl2-26b at 4 of 48
# layers. The process runs with the allocator's expandable segments:
# with its fixed segments the per-leaf updates of 1.5 GiB leaves left
# ~10.5 GiB of the reserved memory free but in pieces, and
# internvl2-26b's 4 layers ran out of the card at 64 GiB allocated.
FAMILY_TRAIN = {
    "llama4-scout-17b-a16e": (1, 4, 0, 2048, None),
    "internvl2-26b": (4, 4, 256, 1792, None),
    "musicgen-medium": (None, 8, 64, 999, None),
}
FAMILY_STEPS = 10
FAMILY_CHECK_LAYERS = 2
FAMILY_PEAK_GIB = 72.0
FAMILY_RECKON_TOL = 0.10    # |peak / reckoned - 1| at most
# The attention backward at each family's step shape: (label, B, H, KV,
# Tq, Tk, hd, window, a row with no admissible key); all three timed.
FAMILY_BWD = [("llama4-scout step", 4, 40, 8, 2048, 2048, 128, 8192, False),
              ("internvl2-26b step", 4, 48, 8, 2048, 2048, 128, 0, False),
              ("musicgen-medium step", 8, 24, 24, 1063, 1063, 64, 0,
               False)]


def family_path(arch: str) -> str:
    n_layers, B, P, T, vocab = FAMILY_TRAIN[arch]
    return (f"{arch} train ({FAMILY_STEPS} steps" + (
        f", {n_layers} layer{'s' if n_layers > 1 else ''}" if n_layers
        else "") + (f", vocabulary {vocab}" if vocab else "") + ")")


def serve_dense(arch, dev, seed) -> dict:
    """Phase 16.1 for one dense config: phases 4 and 7 on a full-width
    bf16 engine (`serve_and_trace`; flash and decode launch counts
    exact), then phase 5's logits check at DENSE_LOGITS_LAYERS layers."""
    from repro_torch.configs import get_config

    n_layers = DENSE_SERVED[arch]
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    label = arch + (f" ({n_layers} of {get_config(arch).n_layers} layers)"
                    if n_layers else "")
    phase(f"16.1 serve {label}")
    t0 = time.perf_counter()
    run = serve_and_trace(cfg, label, ("flash_attention",
                                       "decode_attention"), dev, seed,
                          "16.1")
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}
    if {k: run["launches"][k] for k in want} != want:
        fail(f"{label}: launches {run['launches']}, want {want}")
    walls = {"serve_and_trace": time.perf_counter() - t0}
    phase(f"16.1 {arch} logits at {DENSE_LOGITS_LAYERS} layers, kernels "
          f"vs plain (phase 5)")
    t0 = time.perf_counter()
    logits = compare_paths(dev, seed, arch, DENSE_LOGITS_LAYERS)
    walls["logits"] = time.perf_counter() - t0
    print(f"  walls s {walls}", flush=True)
    runs = run["runs"]
    return dict(path=f"{label} served", config=arch, walls_s=walls,
                layers=cfg.n_layers, params_b=run["params"] / 1e9,
                launches=run["launches"],
                ttft_ms=[r["ttft_s"] * 1e3 for r in runs],
                tok_per_s=[r["tok_per_s"] for r in runs],
                wall_s=[r["wall_s"] for r in runs], peak_gib=run["peak_gib"],
                trace=run["trace"], logits=logits)


def train_family(arch, dev, seed) -> dict:
    """Phase 16.2 for one family: every gradient leaf kernels vs plain at
    FAMILY_CHECK_LAYERS layers, full width (phase 11.2's criteria), then
    the FAMILY_STEPS steps in a fresh process (`family_steps`; the
    allocator's expandable segments on, see FAMILY_TRAIN), whose output
    is printed here and whose numbers it returns."""
    import gc
    import os

    phase(f"16.2 {arch}: a {FAMILY_CHECK_LAYERS}-layer full-width train "
          f"step, kernels vs plain")
    _, B, P, T, _ = FAMILY_TRAIN[arch]
    t0 = time.perf_counter()
    check = check_train_step(dev, seed, arch, FAMILY_CHECK_LAYERS, B, T, P)
    gc.collect()
    torch.cuda.empty_cache()
    walls = {"check": time.perf_counter() - t0}
    phase(f"16.2 {family_path(arch)}, in a process of its own")
    print(f"  this process holds {torch.cuda.memory_reserved() / 2 ** 30:.2f}"
          f" GiB of the card's memory meanwhile", flush=True)
    t0 = time.perf_counter()
    try:
        p = subprocess.run(
            [sys.executable, "-c", f"import chip_smoke as cs; "
             f"cs.family_steps({arch!r}, {seed})"], capture_output=True,
            text=True, cwd=ROOT, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    except subprocess.TimeoutExpired:
        fail(f"{arch}: the training process ran past 600 s")
    lines = p.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if p.returncode:
        fail(f"{arch}: the training process exited {p.returncode}:\n"
             f"{(lines[-1:] or [''])[0]}\n{p.stderr[-4000:]}")
    run = json.loads(lines[-1])["family_steps"]
    walls["process"] = time.perf_counter() - t0
    run["walls_s"] = dict(walls, **run["walls_s"])
    print(f"  walls s {run['walls_s']}", flush=True)
    run.update(path=family_path(arch), train_step_check=check)
    return run


def reckon_train_peak(cfg, params_b, largest_b, B, P, T) -> float:
    """Bytes a bf16 training step of `cfg` at B x (P + T) should peak at
    under the port's in-place AdamW: 12 B a parameter (weight and gradient
    2 each, the f32 moments 8); the larger of the update's temporaries, 24
    B an element of one piece (`optimizer.PIECE`, or the largest leaf
    where smaller), and the global norm's, the f32 squares of the largest
    leaf (4 B an element); the layer inputs remat keeps (2 B x layers x B
    x (P + T) x d) and one CE chunk's f32 logits, their softmax and their
    gradient (12 B x B x chunk x the vocabulary; a codebook config's heads
    take their chunks in turn)."""
    from repro_torch.models.layers import _pick_chunk
    from repro_torch.training.optimizer import PIECE

    largest = largest_b * 1e9
    update = max(24 * min(PIECE, largest), 4 * largest)
    acts = 2 * cfg.n_layers * B * (P + T) * cfg.d_model
    ce = 12 * B * _pick_chunk(T, cfg.loss_chunk) * cfg.vocab_size
    return 12 * params_b * 1e9 + update + acts + ce


def family_steps(arch, seed: int = 0) -> None:
    """Phase 16.2's training run of one family, the body of its own
    process: FAMILY_STEPS bf16 steps through the launcher's `train` at
    its FAMILY_TRAIN shape (`train_counted`: the loss must fall, exact
    flash launches a step), peak memory at most FAMILY_PEAK_GIB and
    within FAMILY_RECKON_TOL of its reckoning. Prints its numbers as the last line, {"family_steps":
    ...}."""
    from repro_torch.configs import get_config
    from repro_torch.training.optimizer import AdamWConfig

    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    n_layers, B, P, T, vocab = FAMILY_TRAIN[arch]
    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=n_layers or base.n_layers,
                              vocab_size=vocab or base.vocab_size)
    r = 2 if cfg.remat else 1
    run = train_counted(
        cfg, AdamWConfig(**dict(TRAIN_OPT, total_steps=FAMILY_STEPS)),
        PrefixStream(cfg, B, P, T), FAMILY_STEPS,
        {"flash_attention": r * cfg.n_layers,
         "flash_attention_bwd": cfg.n_layers},
        f"{arch} ({cfg.n_layers} of {base.n_layers} layers)", dev, seed)
    run["reckoned_peak_gib"] = reckon_train_peak(
        cfg, run["params_b"], run["largest_leaf_b"], B, P, T) / 2 ** 30
    ratio = run["peak_gib"] / run["reckoned_peak_gib"]
    print(f"  peak {run['peak_gib']:.2f} GiB allocated, reckoned "
          f"{run['reckoned_peak_gib']:.2f} (12 B a parameter + an update "
          f"piece or the norm's squares + remat's layer inputs + a CE "
          f"chunk; {ratio:.3f} of it, within {FAMILY_RECKON_TOL:.0%}); at "
          f"most {FAMILY_PEAK_GIB}", flush=True)
    if run["peak_gib"] > FAMILY_PEAK_GIB:
        fail(f"{arch}: peak {run['peak_gib']:.2f} GiB is over "
             f"{FAMILY_PEAK_GIB} GiB")
    if abs(ratio - 1) > FAMILY_RECKON_TOL:
        fail(f"{arch}: peak {run['peak_gib']:.2f} GiB is {ratio:.3f} of "
             f"its reckoning")
    run["walls_s"] = {"train_and_trace": time.perf_counter() - t0}
    print(json.dumps({"family_steps": run}), flush=True)


def unseen_configs(dev=None, seed: int = 0) -> dict:
    """Phase 16: the configurations that had run only on the CPU. To run
    it alone: python -c "import chip_smoke as cs; cs.unseen_configs()".
    Returns the phase's numbers; fails on any check."""
    if dev is None:
        if not torch.cuda.is_available():
            fail("no CUDA device")
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out, walls = {}, {}

    def timed_part(label, fn):
        t = time.perf_counter()
        got = fn()
        walls[label] = time.perf_counter() - t
        print(f"  {label} took {walls[label]:.1f}s", flush=True)
        return got

    phase("16.1 attention at the dense configs' served shapes (phases 3 "
          "and 6)")
    out["attention"], out["attention_worst"] = timed_part(
        "attention", lambda: check_and_time_attention_moe_io(
            dev, seed, DENSE_ATTENTION))
    out["serving"] = {arch: timed_part(arch, lambda a=arch: serve_dense(
        a, dev, seed)) for arch in DENSE_SERVED}
    phase("16.2 the attention backward at the families' step shapes "
          "(phases 11.1 and 11.5)")

    def bwd():
        errs, timed = check_attention_bwd(dev, seed, FAMILY_BWD,
                                          [c[0] for c in FAMILY_BWD])
        return dict(errors=errs, timed=time_attention_bwd_rows(timed))

    out["attention_bwd"] = timed_part("attention_bwd", bwd)
    torch.cuda.empty_cache()
    out["training"] = {arch: timed_part(f"{arch} train", lambda a=arch:
                                        train_family(a, dev, seed))
                       for arch in FAMILY_TRAIN}
    out["walls_s"] = walls
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 16 took {out['wall_s']:.1f}s", flush=True)
    return out


def merge_unseen_rows(rows, unseen) -> None:
    """Phase 16's numbers in the kernel table: the attention rows and the
    backward's gain the new paths' launches; their times at the new
    shapes go under "dense" (forward, decode) and "family_steps" (the
    backward)."""
    runs = [*unseen["serving"].values(), *unseen["training"].values()]
    for r in rows:
        for run in runs:
            n = run["launches"].get(r["name"], 0)
            if n:
                r["launches_by_path"][run["path"]] = n
                r["launches"] += n
        if r["name"] in ("flash_attention", "decode_attention"):
            key = "flash" if r["name"].startswith("flash") else "decode"
            r["dense"] = {label: t[key]
                          for label, t in unseen["attention"].items()}
        elif r["name"] == "flash_attention_bwd":
            r["family_steps"] = unseen["attention_bwd"]["timed"]


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
    # the card's memory for the later phases (16.2 trains near its end)
    del engine, reqs, main_inputs
    torch.cuda.empty_cache()
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

    phase("9. plan on the card, replan in the loop")
    t0 = time.perf_counter()
    planning = plan_and_replan()
    print(f"  phase 9 took {time.perf_counter() - t0:.1f}s")
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"allocator": planning["allocator"]}))
    print(json.dumps({"closed_loop": planning["closed_loop"]}))

    # Phase 14's dry-runs need only the host: they run beside phases 10-14
    # (which keep the card busy), each in a process on a core of its own.
    phase("14.4 the dry-runs start (subprocesses, fake process groups)")
    dryruns = start_dryruns(), time.perf_counter()
    moe_io = moe_and_io(dev, args.seed)
    rows = merge_moe_io_rows(rows, moe_io)
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"moe_io": {k: v for k, v in moe_io.items()
                                 if k not in ("int8", "attention")}}))

    trained = train_and_check(dev, args.seed)
    for r in rows:
        if r["name"] == "flash_attention":
            n = trained["training"]["launches"]["flash_attention"]
            r["launches_by_path"][TRAIN_PATH] = n
            r["launches"] += n
            r["train_fwd"] = {
                "shape": trained["bwd_row"]["shape"],
                "ms": trained["training"]["fwd_ms"],
                "with_lse_ms": trained["training"]["fwd_with_lse_ms"]}
    rows.insert(1, trained["bwd_row"])
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"training": trained["training"]}))

    recurrent = train_recurrent(dev, args.seed)
    for arch, run in recurrent["training_recurrent"]["runs"].items():
        for r in rows:
            n = run["launches"].get(r["name"], 0)
            if n and r["name"] in run["launches_per_step"]:
                r["launches_by_path"][recurrent_path(arch)] = n
                r["launches"] += n
    at = {r["name"]: i for i, r in enumerate(rows)}
    for row in recurrent["rows"]:
        rows.insert(at[row["name"][:-len("_bwd")]] + 1, row)
        at = {r["name"]: i for i, r in enumerate(rows)}
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"training_recurrent":
                      recurrent["training_recurrent"]}))

    distribution = shard_and_pipeline(dev, args.seed)
    for r in rows:
        for label in ("sharded", "seq_sharded", "pipeline"):
            n = distribution[label]["launches"].get(r["name"], 0)
            if n:
                r["launches_by_path"][distribution[label]["path"]] = n
                r["launches"] += n
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"distribution": distribution}))

    mixers = mixers_under_a_mesh(dev, args.seed, dryruns)
    for r in rows:
        name = INT8_WGMMA if r["name"] == "int8_grouped_matmul" else r["name"]
        for run in (*mixers["serving"].values(),
                    *mixers["training"].values()):
            n = run["launches"].get(name, 0)
            if n:
                r["launches_by_path"][run["path"]] = n
                r["launches"] += n
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"mixers": mixers}))

    t0 = time.perf_counter()
    examples = run_examples()
    for r in rows:
        for name, run in examples.items():
            n = run["launches"].get(r["name"], 0)
            if n:
                r["launches_by_path"][example_path(name)] = n
                r["launches"] += n
    print(f"  phase 15 took {time.perf_counter() - t0:.1f}s")
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"examples": examples}))

    unseen = unseen_configs(dev, args.seed)
    merge_unseen_rows(rows, unseen)
    print(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"unseen_configs": unseen}))

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
