"""The integer instructions the flash kernels' keep mask adds, counted in
their SASS (``cuobjdump -sass`` on the machine with the toolkit).

:func:`keep_mask_int_ops` is what ``chip_smoke.py`` uses for the integer
part of a dropout kernel's bound.  It takes the integer instructions of
the dropout instantiation less those of the same kernel without it, and
divides them by the scores a thread makes keep bits for in one pass of
the kernel's loop body: each tile's code appears once there, so the
static difference is what a thread issues for those scores (Philox, the
counter, the lane-pair exchange, the threshold compares and the packing
of the bits).  The few instructions the compiler hoists out of the loop
(the key, the counter words fixed for the thread) are counted as if
they ran every tile, so the count errs by those few upward.

From the command line, ``python -m paddle_tpu_torch.tools.sass_counts
SOURCE MATCH`` builds SOURCE from the checkout's ``csrc/`` and prints,
for each kernel whose mangled name contains MATCH, its SASS instruction
total, its integer instructions by pipe and its commonest opcodes.

The difference is split by pipe: IMAD and IMUL issue to the FMA pipe,
the other integer instructions to the ALU pipe (Nsight Compute's kernel
profiling guide, "Pipelines"; CUDA C++ Programming Guide, arithmetic
instruction throughput, compute capability 9.0: 64 results a clock an
SM for each).
"""
from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

# opcodes that issue to the integer pipes: everything but floating
# point, conversions, memory, control, the tensor cores and the
# special-function unit; FMA_PIPE of them to the FMA pipe, the rest to
# the ALU
INT_OPS = ("IMAD", "IADD3", "IADD", "IMUL", "LOP3", "LOP", "SHF", "SHL",
           "SHR", "ISETP", "SEL", "LEA", "PRMT", "IMNMX", "IABS", "POPC",
           "FLO", "BREV", "BMSK", "SGXT", "ICMP", "VIADD", "VIMNMX")
FMA_PIPE = ("IMAD", "IMUL")

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Za-z0-9_.]*)")


def cuobjdump_path() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    from paddle_tpu_torch.ops.kernels import _build
    cand = Path(_build.nvcc_path()).with_name("cuobjdump")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("cuobjdump not found beside nvcc or on PATH")


def sass_opcodes(library: Path) -> dict:
    """{mangled kernel name: Counter of full opcodes} of a library."""
    text = subprocess.run([cuobjdump_path(), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        if cur is not None:
            m = _INSTR.search(line)
            if m:
                cur[m.group(1)] += 1
    return out


def pipes(ops: collections.Counter) -> dict:
    """The integer instructions of an opcode count, by pipe."""
    fma = alu = 0
    for op, c in ops.items():
        base = op.split(".")[0]
        if base in FMA_PIPE:
            fma += c
        elif base in INT_OPS:
            alu += c
    return dict(fma=fma, alu=alu)


def keep_mask_int_ops(source: str, with_drop: str, without: str,
                      scores: int) -> dict:
    """The integer instructions a score's keep bit costs in kernel
    ``with_drop`` (a substring of its mangled name) against kernel
    ``without`` (the same kernel without dropout), whose loop body makes
    the bits of ``scores`` scores a thread: returns both kernels' counts
    by pipe, the differences (``extra``) and ``per_score`` by pipe."""
    from paddle_tpu_torch.ops.kernels import _build
    (lib,) = _build.build([source])
    funcs = sass_opcodes(lib)

    def one(sub):
        names = [n for n in funcs if sub in n]
        if len(names) != 1:
            raise RuntimeError(f"{source}: {len(names)} kernels match {sub!r}"
                               f": {names}")
        return pipes(funcs[names[0]])

    a, b = one(with_drop), one(without)
    extra = {p: a[p] - b[p] for p in a}
    return dict(with_dropout=a, without=b, extra=extra, scores=scores,
                per_score={p: n / scores for p, n in extra.items()})


def main(argv) -> int:
    from paddle_tpu_torch.ops.kernels import _build
    source, match = argv
    (lib,) = _build.build([source])
    for name, ops in sorted(sass_opcodes(lib).items()):
        if match in name:
            print(name, "total", sum(ops.values()), "pipes", pipes(ops))
            print("   ", ", ".join(f"{o}:{c}"
                                   for o, c in ops.most_common(30)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
