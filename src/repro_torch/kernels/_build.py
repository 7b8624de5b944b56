"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one `.cu` file under `csrc/` with a plain C entry point.
`load(name)` compiles it at first use into a shared library under
`build/kernels/` at the root of the checkout, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. `build_all()` starts one nvcc per missing library, all at once.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "decode_attention_hd", "rwkv6_wkv", "rwkv6_wkv_bwd", "ssm_scan",
           "ssm_scan_bwd", "int8_grouped_matmul", "int8_grouped_matmul_wgmma")
HEADERS = ("common.cuh", "hopper.cuh", "scan.cuh", "tma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = Path("/usr/local/cuda/bin/nvcc")
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where `name`'s library lives for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu", *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every library in `names` that is missing, in parallel.
    Returns nvcc's output (ptxas register and shared-memory report) per
    kernel built; raises if any build fails."""
    if not (missing := [n for n in names if not library_path(n).exists()]):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {n: _start(n) for n in missing}
    logs, failed = {}, []
    for n, (proc, tmp, out) in jobs.items():
        logs[n], _ = proc.communicate()
        if proc.returncode == 0:
            tmp.replace(out)    # atomic: a concurrent loader sees all or none
        else:
            failed.append(n)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _loaded:
        build_all((name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def opcode_mix(name: str) -> dict[str, collections.Counter]:
    """The SASS opcode counts of every kernel function in `name`'s library
    (built first if needed), by `cuobjdump -sass`, keyed by the function's
    mangled name. HMMA counts the warp-level tensor-core products (mma.sync
    f16/bf16/TF32), HGMMA the warpgroup ones (wgmma)."""
    build_all((name,))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    mix = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]+)", body)
        mix[body.split("\n", 1)[0].strip()] = collections.Counter(
            op.split(".")[0] for op in ops)
    return mix
