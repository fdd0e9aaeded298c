"""K1's and K5's machine code against another commit's.  Not a test: a
record, run by hand on a host with the CUDA toolkit.

Builds ``alifmm_tpu_torch/csrc/sweep.cu`` of this checkout and of another
one (a directory holding that commit's ``alifmm_tpu_torch/csrc``, unpacked
with ``git archive``) with the port's nvcc flags, disassembles both with
``cuobjdump -sass`` and prints, for each kernel instantiation, whether
its instructions are identical.  The anonymous namespace's hash differs
between builds, so names are compared without it; addresses are
dropped.

Usage:  python tests/k1_sass_records.py path/to/other/checkout"""

import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from alifmm_tpu_torch.ops import _build  # noqa: E402


def sass(source, out_dir):
    """{kernel name: instructions} of ``source`` built with the port's
    flags."""
    so = os.path.join(out_dir, f"{abs(hash(source))}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, source],
                   check=True, capture_output=True, text=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                          m.group(1))
            funcs[name] = []
        elif name and "/*" in line:
            funcs[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "",
                                      line).strip())
    return funcs


def main(other):
    with tempfile.TemporaryDirectory() as tmp:
        mine = sass(os.path.join(_build.CSRC, "sweep.cu"), tmp)
        theirs = sass(os.path.join(other, "alifmm_tpu_torch", "csrc",
                                   "sweep.cu"), tmp)
    for name in sorted(set(mine) | set(theirs)):
        a, b = mine.get(name), theirs.get(name)
        print(f"{name}: identical {a == b} ({len(a or [])} / "
              f"{len(b or [])} instructions)")
    return 0 if mine == theirs else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
