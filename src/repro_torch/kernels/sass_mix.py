"""Static instruction mix of the matmul kernels, read from their SASS.

    python -m repro_torch.kernels.sass_mix

Builds the kernels if their libraries are missing (:func:`build.build_all`,
which needs ``nvcc``), disassembles them with ``cuobjdump -sass`` (next to
``nvcc``) and prints one JSON object: for each kernel, its instruction count
and how many of those are integer multiply-adds (IMAD, without its
MOV/SHL/IADD move and shift forms), other integer ALU work, shared and
global loads, and tensor-core or dp4a instructions.  ptxas puts shifts and
adds on the IMAD pipe (``IMAD.SHL``, ``IMAD.IADD``) as it likes, so read
this before trusting an instruction count.  No card is needed.
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

from . import build

# kernel -> (source stem, a substring of its mangled name)
KERNELS = {
    "int4_matmul (M tile 16)": ("int4_matmul", "int4_matmul_kernelILi16E"),
    "int4_matmul_tc": ("int4_matmul", "int4_matmul_tc_kernel"),
    "packed_matmul (M tile 16, INT4_EXACT)": ("packed_matmul",
                                              "packed_matmul_kernelILi16ELi1ELi1ELb0ELb1E"),
    "packed_matmul_tiled (INT4_EXACT)": ("packed_matmul",
                                         "packed_matmul_tiled_kernelILi4ELi11ELi1ELi4ELb0E"),
    "packed_matmul_prepacked (M tile 4, 4 columns a thread, fused)": (
        "packed_matmul", "packed_matmul_kernelILi4ELi2ELi4ELb1ELb0E"),
    "packed_matmul_prepacked_tiled (a4w4-p10-n32-mr+full-c2, fused)": (
        "packed_matmul", "packed_matmul_prepacked_tiled_kernelILb1ELb1ELb0ELi32ELi10ELi2ELi1E"),
}

_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)")
_CLASSES = {  # opcode, or opcode.first-modifier -> class
    **dict.fromkeys(("IMAD", "IMAD.WIDE", "IMAD.HI"), "IMAD"),
    **dict.fromkeys(("IADD3", "LOP3", "SHF", "PRMT", "LEA", "SEL", "ISETP", "IMNMX",
                     "VIADD", "SGXT", "IMAD.MOV", "IMAD.SHL", "IMAD.IADD", "IABS",
                     "VIMNMX"), "int ALU"),
    "LDS": "LDS", "LDSM": "LDS", "LDG": "LDG/LDGSTS", "LDGSTS": "LDG/LDGSTS",
    "IMMA": "IMMA/IDP", "IDP": "IMMA/IDP",
}


def sass_mix() -> dict[str, dict[str, int]]:
    """``{kernel: {"instructions": n, class: count, ...}}`` for :data:`KERNELS`."""
    build.build_all()
    tool = Path(build._nvcc()).with_name("cuobjdump")
    dumps: dict[str, str] = {}
    mix = {}
    for name, (stem, key) in KERNELS.items():
        if stem not in dumps:
            lib = build._target(build.CSRC / f"{stem}.cu")
            dumps[stem] = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                                         text=True, timeout=300, check=True).stdout
        body = next((f for f in dumps[stem].split("Function : ")[1:]
                     if key in f.split("\n", 1)[0]), None)
        if body is None:
            raise RuntimeError(f"no kernel matching {key!r} in {stem}'s SASS")
        ops = _OP.findall(body)
        counts = dict.fromkeys(dict.fromkeys(_CLASSES.values()), 0)
        for op in ops:
            cls = _CLASSES.get(".".join(op.split(".")[:2])) or _CLASSES.get(op.split(".")[0])
            if cls:
                counts[cls] += 1
        mix[name] = {"instructions": len(ops), **counts}
    return mix


if __name__ == "__main__":
    print(json.dumps(sass_mix(), indent=1))
