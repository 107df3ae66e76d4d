"""Instructions on one thread's path through each kernel, counted in the
SASS that ``cuobjdump -sass`` prints for the built kernel library, and the
issue bound that count gives.

    python -m ldpcsimulation_tpu_torch.tools.sass_count [--sass FILE]

builds the library (or reads a saved ``cuobjdump -sass`` listing) and
prints, for every kernel instance, its static instruction count and its
path length through the global stores, and through the global loads and
stores.

A thread's path is the shortest path through the kernel's control-flow
graph from its entry, through the global stores (all of them, or the first
``stores`` in address order) and, if asked, every global load placed before
the last of those stores, in address order, to an ``EXIT``: the path of a
thread that does its whole share of the work and takes no slow path.  nvcc places the slow paths of the
accurate math functions (the Payne–Hanek reduction of ``cosf``, the
special-operand fix-ups of ``sqrtf``) behind branches or in called
subroutines, so the shortest such path skips them; a subroutine called
without a predicate counts with its own shortest path to ``RET``.  Where
a run-time branch picks one of several copies of the stores, the first copy
in address order is the path's, with the loads inside it and not those of
the other copies.

A kernel with run-time loops (the min-sum kernel's slot loops) has no
single such path: :meth:`Kernel.path_through` gives the path through a
list of its loads and stores in order, one entry per trip of a loop.

The issue bound of a launch is its warp instructions over the card's issue
rate: ``threads × path / 32`` over ``SMs × 4 × SM clock`` (four warp
schedulers per SM, each issuing one instruction per clock).  Half-rate
pipes (integer multiply, conversions, MUFU) can make the real floor
higher; the count is a lower bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import heapq
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Instr", "Kernel", "parse", "disassemble", "find", "issue_ms",
           "STORES", "LOADS"]

#: base opcodes of global (or generic) stores and loads
STORES = frozenset({"STG", "ST"})
LOADS = frozenset({"LDG", "LD"})

_INSTR = re.compile(r"/\*([0-9a-fA-F]{4,})\*/\s*(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L\w+):\s*$")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_LABEL_TARGET = re.compile(r"`\((\.L\w+)\)")
_HEX_TARGET = re.compile(r"\b0x([0-9a-fA-F]+)\b")
_PRED_OPERAND = re.compile(r"!?U?P[0-7T]")


@dataclasses.dataclass
class Instr:
    addr: int
    text: str
    predicated: bool
    op: str  # full opcode, e.g. "IMAD.WIDE.U32"
    target: Optional[int] = None  # branch or call target address

    @property
    def base(self) -> str:
        return self.op.split(".")[0]


@dataclasses.dataclass
class Kernel:
    name: str
    instrs: List[Instr]

    def __post_init__(self):
        self._index = {ins.addr: i for i, ins in enumerate(self.instrs)}

    def _succ(self, i: int) -> List[Tuple[int, int]]:
        """(successor index, extra cost) of instruction i."""
        ins = self.instrs[i]
        nxt = [(i + 1, 0)] if i + 1 < len(self.instrs) else []
        if ins.base in ("BRA", "JMP"):
            operands = ins.text.split(None, 2 if ins.predicated else 1)[-1]
            cond = (ins.predicated or "DIV" in ins.op
                    or any(_PRED_OPERAND.fullmatch(t.strip(","))
                           for t in operands.split()))
            return [(self._at(ins), 0)] + (nxt if cond else [])
        if ins.base in ("EXIT", "RET", "BPT"):
            return nxt if ins.predicated else []
        if ins.base in ("BRX", "JMX"):
            raise ValueError(f"{self.name}: indirect branch at "
                             f"{ins.addr:#x}: {ins.text}")
        if ins.base == "CALL" and not ins.predicated:
            ret = self._shortest(self._at(ins), self._ops({"RET"}))
            if ret is None:
                raise ValueError(f"{self.name}: call at {ins.addr:#x} "
                                 "never returns")
            return [(j, ret + 1) for j, _ in nxt]
        return nxt

    def _at(self, ins: Instr) -> int:
        if ins.target not in self._index:
            raise ValueError(f"{self.name}: no target in {ins.text!r}")
        return self._index[ins.target]

    def _ops(self, bases: Iterable[str]) -> set:
        bases = set(bases)
        return {i for i, ins in enumerate(self.instrs) if ins.base in bases}

    def _shortest(self, start: int, goal: set) -> Optional[int]:
        """Instructions executed from ``start`` (counted) until the first
        instruction in ``goal`` (not counted); None if none is reached."""
        best = {start: 0}
        heap = [(0, start)]
        while heap:
            d, i = heapq.heappop(heap)
            if d > best[i]:
                continue
            if i in goal and i != start:
                return d
            for j, extra in self._succ(i):
                nd = d + 1 + extra
                if nd < best.get(j, nd + 1):
                    best[j] = nd
                    heapq.heappush(heap, (nd, j))
        return None

    def path_length(self, stores: Optional[int] = None,
                    loads: bool = False) -> int:
        """Instructions on the shortest path from the entry to an EXIT
        (counted) through the first ``stores`` global stores (all if None)
        and, with ``loads``, every global load placed before the last of
        them, in address order."""
        stops = sorted(self._ops(STORES))[:stores]
        if not stops:
            raise ValueError(f"{self.name}: no global store")
        if loads:
            stops = sorted(stops + [i for i in self._ops(LOADS)
                                    if i < stops[-1]])
        total, at = 0, 0
        for s in stops + [None]:
            goal = {s} if s is not None else self._ops({"EXIT"})
            d = self._shortest(at, goal) if at != s else 0
            if d is None:
                raise ValueError(f"{self.name}: no path from {at} to "
                                 f"{'EXIT' if s is None else s}")
            total += d
            if s is not None:
                at = s
        return total + 1

    def path_through(self, waypoints: Iterable[int]) -> int:
        """Instructions on the shortest path from the entry through the
        instructions of ``waypoints`` (indices into ``instrs``), in order,
        to an EXIT (counted).  An index twice in a row goes once around the
        loop that holds it: a kernel with run-time loops gets the path of a
        given trip count by naming its loads or stores once per trip."""
        exits = self._ops({"EXIT"})
        total, at = 0, None
        for goal in list(waypoints) + [None]:
            goals = exits if goal is None else {goal}
            d = self._hop(0 if at is None else at, goals, first=at is None)
            if d is None:
                raise ValueError(f"{self.name}: no path from {at} to "
                                 f"{'EXIT' if goal is None else goal}")
            total += d
            at = goal
        return total + 1

    def _hop(self, start: int, goals: set, first: bool) -> Optional[int]:
        """Instructions executed from ``start`` (counted) until the first
        of ``goals`` (not counted), reached after at least one step unless
        ``first`` allows ``start`` itself."""
        if first and start in goals:
            return 0
        best: Dict[int, int] = {}
        heap = [(1 + extra, j) for j, extra in self._succ(start)]
        heapq.heapify(heap)
        while heap:
            d, i = heapq.heappop(heap)
            if i in best:
                continue
            best[i] = d
            if i in goals:
                return d
            for j, extra in self._succ(i):
                if j not in best:
                    heapq.heappush(heap, (d + 1 + extra, j))
        return None

    @property
    def static_count(self) -> int:
        """Instructions of the kernel, without the branch to itself and the
        NOPs that pad its end."""
        n = len(self.instrs)
        while n and (self.instrs[n - 1].base == "NOP"
                     or self.instrs[n - 1].target == self.instrs[n - 1].addr):
            n -= 1
        return n


def _instr(addr: int, text: str, labels: Dict[str, int]) -> Instr:
    tokens = text.split()
    predicated = tokens[0].startswith("@") and tokens[0] != "@PT"
    op = tokens[1] if tokens[0].startswith("@") else tokens[0]
    target = None
    if op.split(".")[0] in ("BRA", "JMP", "CALL"):
        m = _LABEL_TARGET.search(text)
        if m:
            target = labels.get(m.group(1))
        else:
            hexes = _HEX_TARGET.findall(text)
            target = int(hexes[-1], 16) if hexes else None
    return Instr(addr, text, predicated, op, target)


def parse(sass: str) -> Dict[str, Kernel]:
    """Kernels of a ``cuobjdump -sass`` listing by mangled name."""
    out: Dict[str, Kernel] = {}
    blocks: List[Tuple[str, List[str]]] = []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            blocks.append((m.group(1), []))
        elif blocks:
            blocks[-1][1].append(line)
    for name, lines in blocks:
        # labels first: a label names the address of the next instruction
        labels, pending, rows = {}, [], []
        for line in lines:
            lab = _LABEL.match(line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = _INSTR.search(line)
            if m and m.group(2):
                addr = int(m.group(1), 16)
                for p in pending:
                    labels[p] = addr
                pending = []
                rows.append((addr, m.group(2)))
        out[name] = Kernel(name, [_instr(a, t, labels) for a, t in rows])
    return out


def find(kernels: Dict[str, Kernel], key: str) -> Kernel:
    """The one kernel whose mangled name contains ``key`` (e.g.
    ``"awgn_philox_kernelILb1ELb0EE"`` for ``<true, false>``)."""
    hits = [k for name, k in kernels.items() if key in name]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} kernels match {key!r}: "
                       f"{sorted(kernels)}")
    return hits[0]


def _cuobjdump() -> str:
    from ..kernels import build

    path = Path(build._nvcc()).with_name("cuobjdump")
    if path.exists():
        return str(path)
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found (CUDA toolkit)")
    return found


def disassemble(library: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    return subprocess.run([_cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def issue_ms(threads: int, path: int, sm_clock_mhz: float,
             sms: int = 132) -> float:
    """Least time to issue ``threads × path`` thread instructions: one warp
    instruction per clock on each of an SM's four schedulers."""
    warp_instrs = threads * path / 32.0
    return warp_instrs / (sms * 4 * sm_clock_mhz * 1e6) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", type=Path,
                    help="a saved cuobjdump -sass listing (default: build "
                         "the kernel library and disassemble it)")
    args = ap.parse_args(argv)
    if args.sass is not None:
        text = args.sass.read_text()
    else:
        from ..kernels import build

        text = disassemble(build.build()[0])
    print("static\tstores\tld+st\tkernel")
    for name, k in sorted(parse(text).items()):
        cols = []
        for loads in (False, True):
            try:
                cols.append(str(k.path_length(loads=loads)))
            except ValueError:
                cols.append("-")
        print(f"{k.static_count}\t{cols[0]}\t{cols[1]}\t{name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
