"""Instruction counts of a kernel's loops, from its SASS.

    /usr/local/cuda/bin/cuobjdump -sass LIBRARY > kernels.sass
    python3 -m gvamp_tpu_torch.tools.sass_count kernels.sass PATTERN [--per N]

For every function of the ``cuobjdump -sass`` listing whose mangled name
matches the regular expression PATTERN, it prints the function's length
and, for each loop (a branch back to a lower address closes a loop body,
the innermost first), the body's instruction count and its opcodes by
family (the mnemonic before the first dot: ``LDS.128`` counts as
``LDS``), divided by ``--per`` (for example the words one pass of the body
reads, to give counts per word).  The listing comes from the card's
machine (``cuobjdump`` is part of the CUDA toolkit there); the counting
runs anywhere.
"""

from __future__ import annotations

import argparse
import collections
import re
import sys

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_BRANCH = re.compile(r"\bBRA\b[^;]*?(0x[0-9a-f]+)")
_PREDICATE = re.compile(r"^@!?U?P[T0-9]+\s+")


def functions(text: str):
    """[(mangled name, [(address, instruction text)])] of the listing."""
    out = []
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            out.append((m.group(1), []))
            continue
        m = _INSTR.match(line)
        if m and out:
            out[-1][1].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(instr: str) -> str:
    """The mnemonic's family: predicate and modifiers dropped."""
    return _PREDICATE.sub("", instr).split()[0].split(".")[0]


def loops(instrs):
    """[(first address, last address)] of the bodies that a backward
    branch closes, in the listing's order."""
    out = []
    for addr, text in instrs:
        m = _BRANCH.search(text)
        if m and opcode(text) == "BRA" and int(m.group(1), 16) < addr:
            out.append((int(m.group(1), 16), addr))
    return out


def count(text: str, pattern: str):
    """{name: (length, [(first, last, Counter of opcode families)])} for
    the functions whose names match ``pattern``."""
    out = {}
    for name, instrs in functions(text):
        if not re.search(pattern, name):
            continue
        bodies = []
        for lo, hi in loops(instrs):
            ops = collections.Counter(opcode(t) for a, t in instrs
                                      if lo <= a <= hi)
            bodies.append((lo, hi, ops))
        out[name] = (len(instrs), bodies)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sass", help="cuobjdump -sass output")
    ap.add_argument("pattern", help="regular expression on mangled names")
    ap.add_argument("--per", type=float, default=1.0,
                    help="divide each loop's counts by this")
    args = ap.parse_args(argv)
    with open(args.sass) as f:
        found = count(f.read(), args.pattern)
    if not found:
        print(f"no function matches {args.pattern!r}", flush=True)
        return 1
    for name, (length, bodies) in found.items():
        print(f"{name}: {length} instructions", flush=True)
        for lo, hi, ops in bodies:
            total = sum(ops.values())
            fam = ", ".join(f"{k} {v / args.per:g}"
                            for k, v in ops.most_common())
            print(f"  loop {lo:#06x}-{hi:#06x}: {total} instructions, "
                  f"{total / args.per:g} per {args.per:g}: {fam}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
