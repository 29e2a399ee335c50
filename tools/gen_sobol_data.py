"""Generate ``zig_weekend_raytracer_tpu/sampling/sobol_data.npz``.

The Sobol direction numbers are *public data*, not reference-authored code:
  * S. Joe and F. Y. Kuo, "Constructing Sobol sequences with better
    two-dimensional projections", SIAM J. Sci. Comput. 30 (2008);
    tabulated at http://web.maths.unsw.edu.au/~fkuo/sobol/new-joe-kuo-6.21201
  * As tabulated in PBRT-v4 (Apache-2.0) ``src/pbrt/util/sobolmatrices.cpp``
    and (c) 2012 Leonhard Gruenschloss (MIT) for the van-der-Corput matrices.

This script extracts the numeric constants from the read-only reference
checkout (which vendors the same public tables) into a compressed npz so the
framework is standalone.  Only numbers are extracted — no code.

Usage:  python tools/gen_sobol_data.py [reference_sobol_file] [out.npz]
"""

import re
import sys

import numpy as np

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DIMS = 1024
MATRIX_SIZE = 52

HEX = re.compile(r"0x[0-9a-fA-F]+")


def _extract_section(text: str, start_marker: str) -> str:
    start = text.index(start_marker)
    end = text.index("};", start)
    return text[start:end]


def main() -> None:
    src = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/src/math/sobolmatrices.zig"
    out = (
        sys.argv[2]
        if len(sys.argv) > 2
        else "zig_weekend_raytracer_tpu/sampling/sobol_data.npz"
    )
    text = open(src).read()

    sec = _extract_section(text, "SobolMatrices32 = ")
    vals = [int(h, 16) for h in HEX.findall(sec)]
    assert len(vals) == N_DIMS * MATRIX_SIZE, len(vals)
    sobol32 = np.array(vals, dtype=np.uint32).reshape(N_DIMS, MATRIX_SIZE)

    def parse_vdc(marker: str) -> np.ndarray:
        sec = _extract_section(text, marker)
        groups = []
        for g in re.findall(r"\[_\]u64\{([^}]*)\}", sec):
            row = [int(h, 16) for h in HEX.findall(g)]
            row = row + [0] * (MATRIX_SIZE - len(row))
            groups.append(row)
        arr = np.array(groups, dtype=np.uint64)
        assert arr.shape[1] == MATRIX_SIZE, arr.shape
        return arr

    vdc = parse_vdc("VdCSobolMatrices = ")
    vdc_inv = parse_vdc("VdCSobolMatricesInv = ")

    # Store u64 matrices as hi/lo u32 pairs (JAX runs in 32-bit mode).
    def split64(a):
        return (a >> np.uint64(32)).astype(np.uint32), (
            a & np.uint64(0xFFFFFFFF)
        ).astype(np.uint32)

    vdc_hi, vdc_lo = split64(vdc)
    vdc_inv_hi, vdc_inv_lo = split64(vdc_inv)

    np.savez_compressed(
        out,
        sobol32=sobol32,
        vdc_hi=vdc_hi,
        vdc_lo=vdc_lo,
        vdc_inv_hi=vdc_inv_hi,
        vdc_inv_lo=vdc_inv_lo,
    )
    print(
        f"wrote {out}: sobol32 {sobol32.shape}, vdc {vdc.shape}, "
        f"vdc_inv {vdc_inv.shape}"
    )


if __name__ == "__main__":
    main()
