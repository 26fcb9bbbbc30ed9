"""Static instruction mix of the matmul kernels, read from their SASS.

    python -m repro_torch.kernels.sass_mix

Builds the kernels if their libraries are missing (:func:`build.build_all`,
which needs ``nvcc``), disassembles them with ``cuobjdump -sass`` (next to
``nvcc``) and prints one JSON object: for each kernel, its instruction count
and how many of those are integer multiply-adds (IMAD, without its
MOV/SHL/IADD move and shift forms), other integer ALU work, shared and
global loads, and tensor-core or dp4a instructions; the global loads by
width (``LDG.128``, ``LDG.64``, ``LDG.32`` and narrower); and
``wide_ldg_ahead``, for each 64- or 128-bit global load in program order,
the products (plain IMAD, dp4a or mma) issued between the load and the
first instruction that reads what it loaded: a load issued a step ahead
of its use has a step's products between them.  ptxas puts shifts and
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
    "int4_matmul (M tile 4, 8 columns a thread)": ("int4_matmul", "int4_matmul_kernelILi4ELi8E"),
    "int4_matmul (M tile 16, 4 columns a thread)": ("int4_matmul", "int4_matmul_kernelILi16ELi4E"),
    "int4_matmul_tc": ("int4_matmul", "int4_matmul_tc_kernel"),
    "packed_matmul (M tile 4, 8 columns a thread, INT4_EXACT)": (
        "packed_matmul", "packed_matmul_wide_kernelILi4ELi1ELb0E"),
    "packed_matmul (M tile 16, one column, INT4_EXACT)": (
        "packed_matmul", "packed_matmul_kernelILi16ELi1ELi1ELb0ELb1E"),
    "packed_matmul_tiled (INT4_EXACT)": ("packed_matmul",
                                         "packed_matmul_tiled_kernelILi4ELi11ELi1ELi4ELb0E"),
    "packed_matmul_prepacked (M tile 4, 4 columns a thread, fused)": (
        "packed_matmul", "packed_matmul_kernelILi4ELi2ELi4ELb1ELb0E"),
    "packed_matmul_prepacked_tiled (a4w4-p10-n32-mr+full-c2, fused)": (
        "packed_matmul", "packed_matmul_prepacked_tiled_kernelILb1ELb1ELb0ELi32ELi10ELi2ELi1E"),
}

_INS = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_REG = re.compile(r"\bR(\d+)(\.64)?")
_ALL_SOURCES = ("ST", "STG", "STS", "RED", "ATOM", "ATOMS", "ATOMG")  # no register written
_CLASSES = {  # opcode, or opcode.first-modifier -> class
    **dict.fromkeys(("IMAD", "IMAD.WIDE", "IMAD.HI"), "IMAD"),
    **dict.fromkeys(("IADD3", "LOP3", "SHF", "PRMT", "LEA", "SEL", "ISETP", "IMNMX",
                     "VIADD", "SGXT", "IMAD.MOV", "IMAD.SHL", "IMAD.IADD", "IABS",
                     "VIMNMX"), "int ALU"),
    "LDS": "LDS", "LDSM": "LDS", "LDG": "LDG/LDGSTS", "LDGSTS": "LDG/LDGSTS",
    "IMMA": "IMMA/IDP", "IDP": "IMMA/IDP",
}


def _regs(text: str) -> set[int]:
    """Registers named in SASS operand text (``R4.64`` names R4 and R5)."""
    out: set[int] = set()
    for r, pair in _REG.findall(text):
        out |= {int(r), int(r) + 1} if pair else {int(r)}
    return out


def _is_product(op: str) -> bool:
    return op == "IMAD" or op.split(".")[0] in ("IDP", "IMMA")


def _wide_loads_ahead(ins: list[tuple[str, str]]) -> list[int]:
    """For each 64- or 128-bit LDG, the products between it and the first
    later instruction (in program order) that reads a register it loads."""
    ahead = []
    for i, (op, args) in enumerate(ins):
        mods = op.split(".")
        if mods[0] != "LDG" or not {"64", "128"} & set(mods):
            continue
        first = int(re.match(r"\s*R(\d+)", args).group(1))
        dest = set(range(first, first + (4 if "128" in mods else 2)))
        products = 0
        for op2, args2 in ins[i + 1:]:
            sources = args2 if op2.split(".")[0] in _ALL_SOURCES else args2.partition(",")[2]
            if _regs(sources) & dest:
                break
            products += _is_product(op2)
        ahead.append(products)
    return ahead


def sass_mix() -> dict[str, dict]:
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
        ins = _INS.findall(body)
        counts = dict.fromkeys(dict.fromkeys(_CLASSES.values()), 0)
        widths = dict.fromkeys(("LDG.128", "LDG.64", "LDG.32", "LDG.8/16"), 0)
        for op, _ in ins:
            cls = _CLASSES.get(".".join(op.split(".")[:2])) or _CLASSES.get(op.split(".")[0])
            if cls:
                counts[cls] += 1
            if op.startswith("LDG."):
                mods = op.split(".")
                widths["LDG.128" if "128" in mods else "LDG.64" if "64" in mods
                       else "LDG.8/16" if {"U8", "S8", "U16", "S16"} & set(mods)
                       else "LDG.32"] += 1
        mix[name] = {"instructions": len(ins), **counts, **widths,
                     "wide_ldg_ahead": _wide_loads_ahead(ins)}
    return mix


if __name__ == "__main__":
    print(json.dumps(sass_mix(), indent=1))
