#!/usr/bin/env python3
"""Opcode mix of the port's kernels, from their SASS.

    python3 tools/sass_mix.py [LIBRARY ...]

With no argument, builds the two scan libraries (kernels/_build.py) and
prints, for the f32 instantiations that the served models launch
(`ssd_kernel<float, 64, 64>`, `wkv_kernel<float, 64>`), the number of SASS
instructions and the most frequent opcodes, by `cuobjdump -sass`. The
chunk loop is unrolled inside, so the counts are close to one warp's
instructions per chunk. Given library names (`flash_attention_bwd`, ...),
it prints the same for every kernel function of each, so that, say, the
warpgroup products show as HGMMA (bf16) or IGMMA (int8), the warp-level
ones as HMMA or IMMA (`int8_grouped_matmul_wgmma` against the N-major
`int8_grouped_matmul`).
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


def main(libraries: list[str]) -> int:
    from repro_torch.kernels import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    wanted = {lib: None for lib in libraries} or KERNELS
    _build.build_all(tuple(wanted))
    for name, mangled in wanted.items():
        sass = subprocess.run([cuobjdump, "-sass",
                               str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        for body in re.split(r"\n\s+Function : ", sass)[1:]:
            fn = body.split("\n", 1)[0].strip()
            if mangled is not None and mangled not in fn:
                continue
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]+)", body)
            mix = collections.Counter(op.split(".")[0] for op in ops)
            print(f"{name} {mangled or fn}: {len(ops)} instructions "
                  f"(tensor-core: HGMMA {mix['HGMMA']}, HMMA {mix['HMMA']}, "
                  f"IGMMA {mix['IGMMA']}, IMMA {mix['IMMA']}); "
                  + ", ".join(f"{k} {v}" for k, v in mix.most_common(24)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
