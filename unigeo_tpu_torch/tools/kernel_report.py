"""What the compiler made of the kernels of one source: registers, spills and
instruction counts per kernel.

    python -m unigeo_tpu_torch.tools.kernel_report [--source flash_attention_packed.cu]
        [--match f32reg] [--csrc DIR]

It compiles ``csrc/<source>`` once with ``nvcc -Xptxas -v`` (the build's
flags) into a temporary object, reads ptxas's registers and spill bytes per
kernel, disassembles the object with ``cuobjdump -sass`` and counts, per
kernel whose mangled name contains ``--match``, the instructions that say
how it computes: FFMA / FMUL / FADD (f32 on the CUDA cores), LDS and
LDS.128 (shared-memory loads, 16-byte ones), STS and STS.128, LDGSTS
(cp.async), UBLKCP (the TMA's bulk copies), MUFU and MUFU.EX2, SHFL, BAR, LDL / STL (local memory, which
spills land in), any tensor-core instruction (``*MMA*``, e.g. HMMA,
HGMMA; a TF32 product would be one) and every instruction (``total``), and
each kernel's ``ffma_share``, FFMA over every instruction of its static SASS.
``--match f32w512`` reports the f32 body at d = 512.  It prints one JSON
object.  It needs nvcc and cuobjdump (the CUDA toolkit on the machine with
the card).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import tempfile
from typing import List, Optional

# opcode families counted per kernel (an opcode's text before its first dot)
FAMILIES = ("FFMA", "FMUL", "FADD", "LDS", "STS", "LDGSTS", "UBLKCP", "SHFL", "MUFU", "LDL", "STL",
            "BAR")


def _tool(name: str) -> str:
    from unigeo_tpu_torch import _build

    path = os.path.join(os.path.dirname(_build._nvcc()), name)
    path = path if os.path.exists(path) else shutil.which(name)
    if not path:
        raise RuntimeError(f"{name} not found: the CUDA toolkit is needed")
    return path


def ptxas_info(text: str) -> dict:
    """kernel (mangled) -> {registers, spill_stores, spill_loads} from
    ``-Xptxas -v`` output."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_counts(text: str, match: str) -> dict:
    """kernel (mangled) -> instruction counts, for the kernels of
    ``cuobjdump -sass`` output whose names hold ``match``: each family of
    FAMILIES, LDS.128 and STS.128 (16-byte shared accesses), MUFU.EX2,
    tensor_core (any opcode with MMA in it) and total (every instruction)."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1) if match in m.group(1) else None
            if fn:
                out[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][^\s;]*)", line)
        if not (fn and m):
            continue
        op = m.group(1)
        base, counts = op.split(".")[0], out[fn]
        counts["total"] += 1
        if base in FAMILIES:
            counts[base] += 1
        if base in ("LDS", "STS") and ".128" in op:
            counts[base + ".128"] += 1
        if op.startswith("MUFU.EX2"):
            counts["MUFU.EX2"] += 1
        if "MMA" in base:
            counts["tensor_core"] += 1
    return {fn: dict(c) for fn, c in out.items()}


def ffma_share(counts: dict) -> Optional[float]:
    """FFMA over every instruction of one kernel's ``sass_counts`` (None for
    a kernel with no instruction)."""
    return counts.get("FFMA", 0) / counts["total"] if counts.get("total") else None


def template_args(mangled: str) -> List[int]:
    """The integer template arguments of a mangled kernel name (Li8E -> 8)."""
    return [int(x) for x in re.findall(r"Li(\d+)E", mangled)]


def main(argv: Optional[List[str]] = None) -> dict:
    from unigeo_tpu_torch import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="flash_attention_packed.cu")
    ap.add_argument("--match", default="f32reg")
    ap.add_argument("--csrc", default=_build.CSRC_DIR,
                    help="the directory of the sources (default: the package's csrc)")
    args = ap.parse_args(argv)
    src = os.path.join(args.csrc, args.source)
    with tempfile.TemporaryDirectory() as work:
        obj = os.path.join(work, "k.o")
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{args.csrc}", "-Xptxas", "-v",
             "-c", "-o", obj, src],
            capture_output=True, text=True, timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
        info = ptxas_info(proc.stderr + proc.stdout)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", obj], capture_output=True,
                              text=True, timeout=300, check=True).stdout
    counts = sass_counts(sass, args.match)
    kernels = {fn: {"template_args": template_args(fn), **info.get(fn, {}), "sass": c,
                    "ffma_share": ffma_share(c)}
               for fn, c in sorted(counts.items())}
    result = {"source": args.source, "match": args.match, "kernels": kernels}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
