"""Registers, shared memory and spills of the port's CUDA kernels.

Compiles the named sources of ``easy_vitpose_tpu_torch/csrc`` (all by
default) for sm_90a with the port's flags and ``-Xptxas -v``, device code
only, one ``nvcc`` per source in parallel, and prints one line per kernel
(demangled where ``c++filt`` is there): registers, spill stores and loads,
stack frame and static shared memory.  Ends with one JSON line and exits 1
if a kernel whose name matches ``--must-not-spill`` (a regular expression;
by default the tensor-core attentions, the serving GEMMs (K1's bf16 and
float32, K2's int8) and the bf16 training GEMMs) spills, or if ptxas
serializes a kernel's ``wgmma`` instructions (its "wgmma.mma_async
instructions are serialized" warning, printed with the kernel's name).

Usage (a machine with the CUDA toolkit):
    python3 scripts/ptxas_report.py [block train_block ...] [--must-not-spill REGEX]
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from easy_vitpose_tpu_torch import kernels  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\S+)' for")
SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def demangle(names):
    if not names or shutil.which("c++filt") is None:
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def parse(log: str):
    rows, cur = [], None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "spill_stores": 0,
                   "spill_loads": 0, "stack": 0, "smem": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = SPILL.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            cur["smem"] = int(m.group(2) or 0)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", default=list(kernels.SOURCES))
    ap.add_argument("--must-not-spill",
                    default=r"attn_tc::|attn_tf32::|mma_gemm::gemm_kernel|wgq8::gemm_kernel|"
                            r"tf::gemm_tf32_kernel|tg::gemm_(tn2_)?bf16_kernel")
    args = ap.parse_args()
    nvcc = kernels.nvcc_path()
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    tmp = tempfile.mkdtemp()
    procs = {}
    for name in args.sources:
        cmd = [nvcc, *flags, "-Xptxas", "-v", "-cubin", "-I", str(kernels.CSRC),
               "-o", os.path.join(tmp, f"{name}.cubin"), str(kernels.CSRC / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    rows, failed, serialized = [], [], []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(name)
            print(log)
        serialized += [line.strip() for line in log.splitlines() if "serialized" in line]
        for r in parse(log):
            r["source"] = name
            rows.append(r)
    shutil.rmtree(tmp, ignore_errors=True)
    names = demangle([r["kernel"] for r in rows])
    bad = []
    pat = re.compile(args.must_not_spill)
    for r in rows:
        r["kernel"] = names[r["kernel"]]
        print(f"{r['source']:12s} regs {r['registers']!s:>4s} spill {r['spill_stores']:>4d}/"
              f"{r['spill_loads']:<4d} stack {r['stack']:>4d} smem {r['smem']:>6d}  {r['kernel']}")
        if pat.search(r["kernel"]) and (r["spill_stores"] or r["spill_loads"]):
            bad.append(r["kernel"])
    checked = [r for r in rows if pat.search(r["kernel"])]
    print(json.dumps({"kernels": len(rows), "checked": len(checked),
                      "max_registers_checked": max((r["registers"] or 0 for r in checked),
                                                   default=None),
                      "spilling_checked": bad, "failed_sources": failed,
                      "wgmma_serialized": serialized}))
    return 1 if bad or failed or serialized else 0


if __name__ == "__main__":
    sys.exit(main())
