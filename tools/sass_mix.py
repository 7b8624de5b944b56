#!/usr/bin/env python3
"""Opcode mix of the served-shape scan kernels, from their SASS.

    python3 tools/sass_mix.py

Builds the two scan libraries (kernels/_build.py) and prints, for the f32
instantiations that the served models launch (`ssd_kernel<float, 64, 64>`,
`wkv_kernel<float, 64>`), the number of SASS instructions and the most
frequent opcodes, by `cuobjdump -sass`. The chunk loop is unrolled inside,
so the counts are close to one warp's instructions per chunk.
"""
from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

KERNELS = {"ssm_scan": "ssd_kernelIfLi64ELi64E", "rwkv6_wkv": "wkv_kernelIfLi64E"}


def main() -> int:
    from repro_torch.kernels import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    _build.build_all(tuple(KERNELS))
    for name, mangled in KERNELS.items():
        sass = subprocess.run([cuobjdump, "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        body = next(f for f in re.split(r"\n\s+Function : ", sass)
                    if mangled in f.split("\n", 1)[0])
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]+)", body)
        mix = collections.Counter(op.split(".")[0] for op in ops)
        print(f"{name}: {len(ops)} instructions; "
              + ", ".join(f"{k} {v}" for k, v in mix.most_common(24)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
