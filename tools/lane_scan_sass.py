#!/usr/bin/env python3
"""Count the SASS instructions one lane-scan step issues.

    python3 tools/lane_scan_sass.py [--source FILE] [--nb 16] [--out DIR]
    python3 tools/lane_scan_sass.py --source FILE --kernel PATTERN \
        --chunks N [--kernel PATTERN --chunks N ...]

The second form counts other kernels' hot loops: for each function whose
mangled name matches the regular expression ``PATTERN`` (for example
``gemv_int_kernelILi4ELi2E``), its innermost loop found as below, and
the instructions of the longest path through that loop (its steady
state, where every guarded chunk is taken) divided by ``N``, the work
units (16-byte weight chunks, say) one pass of the loop handles; each
``--kernel`` pairs with the ``--chunks`` in its place.

Compiles ``FILE`` (default: the port's ``csrc/lane_scan.cu``) to a cubin
for ``sm_90a`` with the library's own flags plus ``-lineinfo`` (which
adds line tables and leaves the code alone), disassembles it with
``nvdisasm`` and finds the per-command loop of the ``lane_scan_kernel``
instantiated for ``--nb`` banks: the innermost loop (a backward branch
whose span holds no other) with the most instructions.

Each instruction carries the source lines it was inlined through, and
each basic block of the loop the code it holds: ``case X`` of the
``switch (op)``, the switch's own dispatch, or, for an opcode whose step
is a lambda ``step_x`` called ahead of the switch, that lambda and its
call.  The instructions of one step with opcode X are those of the
shortest path through the loop's control-flow graph (branch targets,
``BRX`` jump tables included) that runs X's code and no other opcode's,
and the switch's dispatch only if X goes through it (null for an opcode
with no code of its own, such as NOP).  A loop unrolled by
``#pragma unroll U`` (the last such line before the switch) holds U
steps, so the count is divided by U; for an opcode that goes through
the switch the path then need run its code in only one of the U copies,
so its count is a lower bound (exact for the hot opcodes).  A kernel with no ``switch`` issues the whole loop every
step.  Prints one JSON object; the disassembly goes to
``DIR/<source stem>.sass``.  Needs the CUDA toolkit (``nvcc``,
``nvdisasm``).
"""
import argparse
import collections
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LINE = re.compile(r"//## File \"[^\"]*\", line (\d+)")
SECTION = re.compile(r"\.section\s+\.text\.([^,\s]+)")
TARGET = re.compile(r"`\((\.L_x_\d+)\)")
LABEL = re.compile(r"^(\.L_x_\d+):")
BRANCH = re.compile(r"^(@!?U?P\w+\s+)?BRA(\.\w+)*\s")


def disassemble(source: pathlib.Path, out: pathlib.Path) -> str:
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / f"{source.stem}.cubin"
    nvcc = build.nvcc_path()
    flags = [f for f in build.COMPILE_FLAGS if f not in ("-c", "-Xcompiler",
                                                         "-fPIC")]
    subprocess.run([nvcc, *flags, "-lineinfo", "-cubin", "-o", str(cubin),
                    str(source)], check=True, capture_output=True, text=True)
    nvdisasm = pathlib.Path(nvcc).with_name("nvdisasm")
    text = subprocess.run([str(nvdisasm), "-gi", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    (out / f"{source.stem}.sass").write_text(text)
    return text


def functions(text: str) -> dict[str, list[dict]]:
    """Function name -> instructions [{addr, text, lines, label}]: the
    source lines it was inlined through, and the label it carries if a
    branch targets it."""
    funcs: dict[str, list[dict]] = {}
    cur = None
    lines: list[int] = []
    label = None
    for raw in text.splitlines():
        m = SECTION.search(raw)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            lines, label = [], None
            continue
        if cur is None:
            continue
        m = LINE.findall(raw)
        if m and "//##" in raw:
            lines = [int(n) for n in m]
            continue
        m = LABEL.match(raw.strip())
        if m:
            label = m.group(1)
            continue
        m = INSN.search(raw)
        if m:
            cur.append(dict(addr=int(m.group(1), 16), text=m.group(2).strip(),
                            lines=lines, label=label))
            label = None
    return funcs


def step_loop(insns: list[dict]) -> tuple[int, int]:
    """(first, last) index of the innermost loop with most instructions."""
    at = {ins["label"]: i for i, ins in enumerate(insns) if ins["label"]}
    spans = []
    for i, ins in enumerate(insns):
        if BRANCH.match(ins["text"]):
            m = TARGET.search(ins["text"])
            if m and at.get(m.group(1), i + 1) <= i:
                spans.append((at[m.group(1)], i))
    inner = [s for s in spans
             if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                        for o in spans)]
    if not inner:
        raise SystemExit("no loop found in the kernel")
    return max(inner, key=lambda s: s[1] - s[0])


def basic_blocks(insns: list[dict]) -> list[list[dict]]:
    """Split at branch targets and after branches."""
    blocks: list[list[dict]] = []
    for ins in insns:
        if not blocks or ins["label"] or re.search(
                r"\b(BRA|BRX|EXIT|RET)\b", blocks[-1][-1]["text"]):
            blocks.append([])
        blocks[-1].append(ins)
    return blocks


def shortest_path(blocks: list[list[dict]], allowed: list[bool],
                  own: list[bool]) -> int | None:
    """Fewest instructions from the loop's first block to its last (the
    back branch) through allowed blocks only, passing an ``own`` one."""
    at = {b[0]["label"]: k for k, b in enumerate(blocks) if b[0]["label"]}
    best = {(0, own[0]): len(blocks[0])}
    for k, b in enumerate(blocks):          # forward edges only: a DAG
        text = b[-1]["text"]
        m = re.search(r"BRANCH_TARGETS ([^\"]*)", text)
        if m:
            nxt = [at[t] for t in m.group(1).split(",") if t in at]
        else:
            m = TARGET.search(text) if BRANCH.match(text) else None
            nxt = [at[m.group(1)]] if m and m.group(1) in at else []
            if not (m and not text.startswith("@")):
                nxt.append(k + 1)
        for seen in (False, True):
            cost = best.get((k, seen))
            if cost is None:
                continue
            for n in nxt:
                if k < n < len(blocks) and allowed[n]:
                    key = (n, seen or own[n])
                    if cost + len(blocks[n]) < best.get(key, 1 << 30):
                        best[key] = cost + len(blocks[n])
    return best.get((len(blocks) - 1, True))


def longest_path(blocks: list[list[dict]]) -> int:
    """Most instructions from the loop's first block to its last (the
    back branch), over forward edges."""
    at = {b[0]["label"]: k for k, b in enumerate(blocks) if b[0]["label"]}
    best = {0: len(blocks[0])}
    for k, b in enumerate(blocks):
        if k not in best:
            continue
        text = b[-1]["text"]
        m = TARGET.search(text) if BRANCH.match(text) else None
        nxt = [at[m.group(1)]] if m and m.group(1) in at else []
        if not (m and not text.startswith("@")):
            nxt.append(k + 1)
        for n in nxt:
            if k < n < len(blocks):
                best[n] = max(best.get(n, 0), best[k] + len(blocks[n]))
    return best.get(len(blocks) - 1, max(best.values()))


def closing(src: list[str], start: int) -> int:
    """Index of the line that closes the block opened at ``start``: the
    next line at its indentation that starts with ``}``."""
    indent = len(src[start]) - len(src[start].lstrip())
    return next(i for i in range(start + 1, len(src))
                if src[i].lstrip().startswith("}")
                and len(src[i]) - len(src[i].lstrip()) == indent)


def dispatch(src: list[str]) -> tuple:
    """1-based line spans: of ``switch (op)``, of each of its cases, and
    of each ``step_x`` lambda with its calls outside the switch (by
    opcode name); and the step loop's unroll factor."""
    start = next((i for i, s in enumerate(src)
                  if re.search(r"\bswitch \(op\)", s)), None)
    if start is None:
        return None, {}, {}, 1
    end = closing(src, start)
    heads = [(i, m.group(1) or "default") for i in range(start, end)
             for m in [re.match(r"\s*(?:case (\w+)|default):", src[i])] if m]
    cases: dict = {}
    for k, (i, name) in enumerate(heads):
        j = k + 1               # labels stacked on one body share it
        while j < len(heads) and heads[j][0] == heads[j - 1][0] + 1:
            j += 1
        stop = heads[j][0] if j < len(heads) else end
        cases.setdefault(name, []).append((i + 1, stop + 1))
    steps: dict = {}
    for i, s in enumerate(src):
        m = re.search(r"auto step_(\w+) = \[", s)
        if m:
            steps.setdefault(m.group(1).upper(), []).append(
                (i + 1, closing(src, i) + 2))
        m = re.search(r"\bstep_(\w+)\(\)", s)
        if m and not start <= i <= end:
            steps.setdefault(m.group(1).upper(), []).append((i + 1, i + 2))
    unroll = [int(m.group(1)) for s in src[:start]
              for m in [re.match(r"\s*#pragma unroll (\d+)", s)] if m]
    return (start + 1, end + 2), cases, steps, (unroll or [1])[-1]


def opcode_mix(insns: list[dict]) -> dict:
    kinds = collections.Counter(ins["text"].split()[1 if ins["text"]
                                                   .startswith("@") else 0]
                                .split(".")[0] for ins in insns)
    return dict(kinds.most_common())


def count_loop(funcs: dict, args) -> int:
    """The ``--kernel`` form: one JSON object per matching function."""
    chunks = args.chunks or []
    if len(chunks) != len(args.kernel):
        raise SystemExit("give one --chunks for each --kernel")
    for pattern, per in zip(args.kernel, chunks):
        count_one(funcs, args.source, pattern, per)
    return 0


def count_one(funcs: dict, source, pattern: str, per: float) -> None:
    names = [n for n in funcs if re.search(pattern, n)]
    if not names:
        raise SystemExit(f"no function matches {pattern!r} among "
                         f"{list(funcs)}")
    for name in names:
        insns = [i for i in funcs[name] if i["text"] != "NOP"]
        first, last = step_loop(insns)
        loop = insns[first:last + 1]
        path = longest_path(basic_blocks(loop))
        print(json.dumps(dict(
            source=str(source), function=name,
            kernel_instructions=len(insns), loop_instructions=len(loop),
            loop_longest_path=path, chunks_per_pass=per,
            per_chunk=path / per, loop_mix=opcode_mix(loop))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=pathlib.Path,
                    default=build.CSRC / "lane_scan.cu")
    ap.add_argument("--nb", type=int, default=16)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "chiprun_out" / "sass")
    ap.add_argument("--kernel", action="append", help="regex of another "
                    "kernel's mangled name: count its loop's longest path "
                    "instead")
    ap.add_argument("--chunks", type=float, action="append",
                    help="work units per pass of that loop")
    args = ap.parse_args()

    funcs = functions(disassemble(args.source, args.out))
    if args.kernel:
        return count_loop(funcs, args)
    names = [n for n in funcs
             if "lane_scan_kernel" in n and f"ILi{args.nb}E" in n]
    if len(names) != 1:
        raise SystemExit(f"want one lane_scan_kernel<{args.nb}>, found "
                         f"{names} among {list(funcs)}")
    insns = [i for i in funcs[names[0]] if i["text"] != "NOP"]
    first, last = step_loop(insns)
    loop = insns[first:last + 1]
    span, cases, steps, unroll = dispatch(
        args.source.read_text().splitlines())
    report = dict(source=str(args.source), function=names[0],
                  kernel_instructions=len(insns),
                  loop_instructions=len(loop), loop_mix=opcode_mix(loop),
                  unattributed=sum(not i["lines"] for i in loop))
    if span is None:
        report["per_step"] = {"every opcode": len(loop)}
    else:
        def owners(line: int) -> set:
            if not span[0] <= line < span[1]:
                return {("hot", name) for name, spans in steps.items()
                        if any(a <= line < b for a, b in spans)}
            if line == span[0]:
                return {("switch", "")}
            return {("case", name) for name, spans in cases.items()
                    if any(a <= line < b for a, b in spans)}

        blocks = basic_blocks(loop)
        held = [set().union(*(owners(n) for i in b for n in i["lines"]))
                for b in blocks]

        def issued(name: str) -> float:
            own = ("hot", name) if name in steps else ("case", name)
            via = set() if name in steps else {("switch", "")}
            cost = shortest_path(blocks, [own in h or h <= via for h in held],
                                 [own in h for h in held])
            return None if cost is None else cost / unroll

        report["unroll"] = unroll
        report["per_step"] = {name: issued(name) for name in cases}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
