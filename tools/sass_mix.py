#!/usr/bin/env python3
"""Opcode mix of the port's kernels, from their SASS.

    python3 tools/sass_mix.py [LIBRARY ...]

With no argument, builds the four scan libraries (kernels/_build.py) and
prints, for the f32 instantiations that the models launch
(`ssd_kernel<float, 64, 64>`, `wkv_kernel<float, 64>` and the backwards'
`ssd_bwd_kernel<float, 64, 64>`, `wkv_bwd_kernel<float, 64>`), the number
of SASS instructions and the most frequent opcodes, by `cuobjdump -sass`.
The forwards' chunk loop is unrolled inside, so their counts are close to
one warp's instructions per chunk; the backwards' phases loop over jobs,
so theirs are code size only. Given library names
(`flash_attention_bwd`, ...), it prints the same for every kernel
function of each, so that, say, the warpgroup products show as HGMMA
(bf16) or IGMMA (int8), the warp-level ones as HMMA or IMMA
(`int8_grouped_matmul_wgmma` against the N-major `int8_grouped_matmul`).
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

KERNELS = {"ssm_scan": "ssd_kernelIfLi64ELi64E",
           "rwkv6_wkv": "wkv_kernelIfLi64E",
           "ssm_scan_bwd": "ssd_bwd_kernelIfLi64ELi64E",
           "rwkv6_wkv_bwd": "wkv_bwd_kernelIfLi64E"}


def main(libraries: list[str]) -> int:
    from repro_torch.kernels import _build

    wanted = {lib: None for lib in libraries} or KERNELS
    _build.build_all(tuple(wanted))
    for name, mangled in wanted.items():
        for fn, mix in _build.opcode_mix(name).items():
            if mangled is not None and mangled not in fn:
                continue
            print(f"{name} {mangled or fn}: {sum(mix.values())} instructions "
                  f"(tensor-core: HGMMA {mix['HGMMA']}, HMMA {mix['HMMA']}, "
                  f"IGMMA {mix['IGMMA']}, IMMA {mix['IMMA']}); "
                  + ", ".join(f"{k} {v}" for k, v in mix.most_common(24)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
