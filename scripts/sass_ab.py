#!/usr/bin/env python3
"""Compare the machine code (SASS) of the decode's kernels in two
checkouts of the PyTorch port: whether a kernel's main-path build is the
same code in both.

    python3 scripts/sass_ab.py PARENT_ROOT CHANGE_ROOT [SOURCE.cu ...]

Each root's csrc/SOURCE.cu (default: the four kernels that -trace gave a
record mode) is compiled to a cubin with the flags of this repository's
kernels.py, and cuobjdump lists its SASS. A kernel is paired by name
across the roots; a template instantiation <false> stands for the
non-template kernel of the same name, and <true> (a record mode) is
listed but not paired. Before comparing, each instruction loses its
address and encoding, and every constant-bank offset and branch target
is masked, so that a kernel whose argument block grew but whose code did
not compares equal.
Prints, per pair, the registers and instruction count of each side, the
number of instructions that differ and the first SHOW runs of them, then
one JSON line. Needs nvcc
and cuobjdump (a CUDA toolkit), not a card.
"""

import difflib
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ("pe_fused.cu", "gcr_fused.cu", "nrzi_slot.cu", "ww_fused.cu")
SHOW = 12           # differing runs printed per kernel


def tool(name):
    for d in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin"), *os.environ.get("PATH", "").split(":")):
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    sys.exit(f"sass_ab: no {name}")


def compile_all(root, srcs, out_dir):
    """One nvcc per source, all started together. Returns {src: cubin}."""
    sys.path.insert(0, HERE)
    from readtape_tpu_torch.kernels import NVCC_FLAGS
    csrc = os.path.join(root, "readtape_tpu_torch", "csrc")
    jobs = {}
    for src in srcs:
        cub = os.path.join(out_dir, src + ".cubin")
        jobs[src] = (cub, subprocess.Popen(
            [tool("nvcc"), *NVCC_FLAGS, "-I", csrc, "-cubin", "-o", cub,
             os.path.join(csrc, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for src, (cub, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"sass_ab: nvcc failed on {root}'s {src}\n{log}")
        out[src] = cub
    return out


def kernel_key(mangled):
    """(base name, instantiation): "" for a non-template kernel, "false"
    or "true" for a <bool> template's."""
    m = re.match(r"_Z\d+", mangled)
    if not m:
        return mangled, ""
    n = int(mangled[2:m.end()])
    base = mangled[m.end():m.end() + n]
    rest = mangled[m.end() + n:]
    inst = ("true" if rest.startswith("ILb1E") else
            "false" if rest.startswith("ILb0E") else "")
    return base, inst


def sass(cubin):
    """{(base, inst): (registers, normalized instructions)}."""
    text = subprocess.run([tool("cuobjdump"), "-sass", cubin],
                          capture_output=True, text=True, check=True).stdout
    res = subprocess.run([tool("cuobjdump"), "-res-usage", cubin],
                         capture_output=True, text=True, check=True).stdout
    regs, fn = {}, None
    for line in res.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and fn:
            ins = re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[*][*]",
                         m.group(1))
            if re.search(r"\b(BRA|BSSY|CALL|JMP|SSY|PBK|BRX)\b", ins):
                ins = re.sub(r"0x[0-9a-f]+", "0x*", ins)   # branch targets
            out[fn].append(re.sub(r"\s+", " ", ins))
    return {kernel_key(f): (regs.get(f), ins) for f, ins in out.items()}


def main():
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    roots = [os.path.abspath(r) for r in sys.argv[1:3]]
    srcs = sys.argv[3:] or DEFAULT
    result = {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        cubins = []
        for i, root in enumerate(roots):
            d = os.path.join(tmp, str(i))
            os.makedirs(d)
            cubins.append(compile_all(root, srcs, d))
        for src in srcs:
            old, new = sass(cubins[0][src]), sass(cubins[1][src])
            for (base, inst), (r1, ins1) in sorted(new.items()):
                if inst == "true":
                    print(f"{src} {base}<true>: {r1} registers, "
                          f"{len(ins1)} instructions (record mode)")
                    result[f"{base}<true>"] = dict(regs=r1, n=len(ins1))
                    continue
                key = next((k for k in ((base, ""), (base, inst))
                            if k in old), None)
                if key is None:
                    continue
                r0, ins0 = old[key]
                ops = [op for op in difflib.SequenceMatcher(
                    None, ins0, ins1, autojunk=False).get_opcodes()
                    if op[0] != "equal"]
                diff = sum(max(i2 - i1, j2 - j1)
                           for _, i1, i2, j1, j2 in ops)
                print(f"{src} {base}: registers {r0} -> {r1}, instructions "
                      f"{len(ins0)} -> {len(ins1)}, {diff} differ")
                for _, i1, i2, j1, j2 in ops[:SHOW]:
                    print(f"  @{i1}: {' | '.join(ins0[i1:i2])}  ->  "
                          f"{' | '.join(ins1[j1:j2])}")
                result[base] = dict(regs=[r0, r1], n=[len(ins0), len(ins1)],
                                    differ=diff)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
