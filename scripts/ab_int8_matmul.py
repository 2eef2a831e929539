#!/usr/bin/env python3
"""The port's int8 matmul kernel against an earlier version of it, on one
NVIDIA GPU, in one process:

    python3 scripts/ab_int8_matmul.py --parent DIR

``DIR`` holds the earlier ``int8_matmul.cu``, e.g. ``git archive <commit>
src/repro_torch/kernels/csrc`` unpacked.  Its C entry,
``int8_matmul_launch(x, w_q, scale, out, part, M, K, N, splits, x_dtype,
stream)``, is the port's: the port's wrapper calls either with the same
arguments (its plan's splits and workspace).

It builds the port's kernels and the earlier source with ``nvcc``, all at
once (``kernels/build.build_each`` for the earlier one), prints every
``int8_matmul`` instance's registers and spills from the ``-Xptxas -v``
reports, and the HMMA instructions in each instance's SASS (``cuobjdump
-sass``): every bfloat16 instance of the port must have some.  It runs
``chip_smoke.py``'s int8 cases on the port's kernel (against the plain
version; in bfloat16 repeated bit-identical, outputs beyond one bf16 step
counted).  Then at llama2-7b's projections (K x N 4096 x 4096, 4096 x
11008, 11008 x 4096) at M = 4 and 8192, in bfloat16 and float32, it times
earlier, port, port, earlier, each as a CUDA graph's replay on inputs
larger than the L2, beside cuBLAS on the dequantized weight, the plain
version and the bound; in float32 the port's outputs must be bit for bit
the earlier kernel's on every input set, and its times are compared with
the earlier kernel's (within 3% expected: the float32 kernel is unchanged).

The earlier kernel is given the plan the earlier wrapper gave it: two
blocks per SM at M <= 16 (at M = 8192 both plans have one split).
``--per-sm N ...`` also times the port at the three M = 4 bfloat16 shapes
with the plan filling N blocks per SM instead of
``int8_matmul.BLOCKS_PER_SM``'s, in turns with the default plan.

It prints one ``ab:`` line per shape and, last, a JSON object of the
numbers.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402


class ParentEntry:
    """The earlier C entry behind the port's wrapper, which then passes it
    exactly the arguments it passes the port's entry."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, device, *args):
        err = self.fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"earlier int8_matmul_launch: CUDA error "
                               f"{err}")


def parent_call(i8, entry, **x):
    port_entry, i8._launch = i8._launch, entry
    try:
        with plan_per_sm(i8, 2):
            return i8.int8_matmul(**x)
    finally:
        i8._launch = port_entry


class plan_per_sm:
    """The wrapper's bfloat16 plan filling ``blocks`` blocks per SM at
    M <= 16, inside the ``with``."""

    def __init__(self, i8, blocks):
        self.table, self.blocks = i8.BLOCKS_PER_SM, blocks

    def __enter__(self):
        self.was = self.table[torch.bfloat16]
        self.table[torch.bfloat16] = (self.blocks, self.was[1])

    def __exit__(self, *exc):
        self.table[torch.bfloat16] = self.was


def typed_parent(lib):
    import ctypes
    fn = lib.int8_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    return ParentEntry(fn)


def instance_lines(log):
    """The compiler's registers and spills of each int8_matmul instance."""
    keep, ours = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = re.search(r"int8_matmul_\w+", line)
            ours = name is not None
            if ours:
                keep.append(name.group(0))
        elif ours and ("registers" in line or "spill" in line):
            keep.append("  " + line.split(":", 1)[-1].strip())
    return keep


def hmma_counts(lib: Path):
    """HMMA instructions in the SASS of each int8_matmul instance of
    ``lib``, by cuobjdump, under its demangled name."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "int8_matmul" in name:
            demangled = subprocess.run(["c++filt", name], capture_output=True,
                                       text=True).stdout.strip() or name
            counts[re.sub(r"^.*?(int8_matmul\w*<.*>).*$", r"\1",
                          demangled)] = part.count("HMMA")
    return counts


def timing_sets(i8, m, k, n, dtype):
    """chip_smoke.py's time_int8 input sets: enough to exceed the L2."""
    item = torch.tensor([], dtype=dtype).element_size()
    n_sets = max(1, -(-100_000_000 // (k * n + m * k * item)))
    return [cs.int8_inputs(i8, m, k, n, dtype, seed=950 + i)
            for i in range(n_sets)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory of the earlier int8_matmul.cu")
    ap.add_argument("--per-sm", type=int, nargs="*", default=[],
                    help="also time the port's M = 4 bf16 shapes with the "
                         "plan filling this many blocks per SM")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_int8_matmul: needs an NVIDIA GPU")
    from repro_torch.kernels import build
    from repro_torch.kernels import int8_matmul as i8
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(build.build_each,
                          {"int8_matmul": args.parent / "int8_matmul.cu"},
                          build.BUILD_DIR.parent / "ab_parent")
        port_lib = build.build().path
        parent_lib, parent_log = job.result()["int8_matmul"]
    print(f"ab: built in {time.perf_counter() - t0:.1f} s")
    for what, log in (("port", build.compiler_logs()["int8_matmul.cu"]),
                      ("earlier", parent_log)):
        for line in instance_lines(log):
            print(f"ab: {what}: {line}")
    hmma = {"port": hmma_counts(port_lib),
            "earlier": hmma_counts(build.BUILD_DIR.parent / "ab_parent"
                                   / "int8_matmul.so")}
    for what, counts in hmma.items():
        for name, n in counts.items():
            print(f"ab: {what}: {n} HMMA in {name}")
    mma = [n for name, n in hmma["port"].items() if "mma_kernel" in name]
    if not mma or not all(mma) or any(
            "bfloat16" in name for name in hmma["port"]
            if "int8_matmul_kernel" in name):
        raise AssertionError("a bfloat16 instance of the port runs no HMMA, "
                             "or the CUDA-core kernel has a bfloat16 one")
    parent = typed_parent(parent_lib)
    worst = cs.check_int8(i8)
    print(f"ab: int8 cases pass, worst error {worst:.3g}")

    result = {}
    for m in cs.INT8_M:
        for k, n in cs.INT8_PROJ:
            for dtype in (torch.bfloat16, torch.float32):
                name = f"M={m} {k}x{n} {str(dtype)[6:]}"
                sets = timing_sets(i8, m, k, n, dtype)
                same = sum(torch.equal(i8.int8_matmul(**x),
                                       parent_call(i8, parent, **x))
                           for x in sets)
                if dtype == torch.float32 and same != len(sets):
                    raise AssertionError(f"{name}: the port's float32 output "
                                         f"is not the earlier kernel's on "
                                         f"{len(sets) - same} of {len(sets)} "
                                         f"sets")
                big = m * k * n > 1e11
                iters = (3 if dtype == torch.float32 else 10) if big else 200
                warm = 2 if big else 10

                def timed(fn):
                    return cs.time_ms(lambda i: fn(**sets[i]), len(sets),
                                      iters=iters, warmup=warm)
                old1 = timed(lambda **x: parent_call(i8, parent, **x))
                port = cs.time_int8(i8, card, m, k, n, dtype)
                new2 = timed(i8.int8_matmul)
                old2 = timed(lambda **x: parent_call(i8, parent, **x))
                plan = i8.tile_plan(m, k, n, torch.cuda.get_device_properties(
                    0).multi_processor_count, dtype)
                ratio = (port["ms"] + new2) / (old1 + old2)
                result[name] = dict(
                    parent_ms=[old1, old2], ms=[port["ms"], new2],
                    library_ms=port["library_ms"], plain_ms=port["plain_ms"],
                    bound_ms=port["bound_ms"], bound_by=port["bound_by"],
                    max_abs_err=port["max_abs_err"],
                    bf16_beyond=port["bf16_beyond"], rows=plan.rows,
                    grid=list(plan.grid), same_bits_sets=[same, len(sets)],
                    port_over_parent=ratio)
                extra = (f"; outputs bit for bit the earlier kernel's on "
                         f"{same}/{len(sets)} sets, time within 3%: "
                         f"{abs(ratio - 1) <= 0.03}"
                         if dtype == torch.float32 else
                         f"; {port['bf16_beyond']} outputs beyond one bf16 "
                         f"step of plain")
                print(f"ab: int8_matmul {name} BM={plan.rows} grid "
                      f"{plan.grid}: earlier {old1:.4f} ms, port "
                      f"{port['ms']:.4f} ms, port {new2:.4f} ms, earlier "
                      f"{old2:.4f} ms (port/earlier {ratio:.3f}); cuBLAS "
                      f"{port['library_ms']:.4f} ms, plain "
                      f"{port['plain_ms']:.4f} ms, bound "
                      f"{port['bound_ms']:.4f} ms ({port['bound_by']}); max "
                      f"abs err {port['max_abs_err']:.3g}{extra} [{card}]")
                del sets
                torch.cuda.empty_cache()
    per_sm = {}
    for k, n in cs.INT8_PROJ if args.per_sm else ():
        sets = timing_sets(i8, cs.INT8_M[0], k, n, torch.bfloat16)
        row = per_sm[f"M={cs.INT8_M[0]} {k}x{n} bfloat16"] = {}
        default = i8.BLOCKS_PER_SM[torch.bfloat16][0]
        for blocks in [default, *args.per_sm, default]:
            with plan_per_sm(i8, blocks):
                row.setdefault(blocks, []).append(cs.time_ms(
                    lambda i: i8.int8_matmul(**sets[i]), len(sets)))
        print(f"ab: int8_matmul M={cs.INT8_M[0]} {k}x{n} bfloat16, ms by "
              f"blocks per SM of the plan: " + ", ".join(
                  f"{b}: {' '.join(f'{t:.4f}' for t in ts)}"
                  for b, ts in row.items()) + f" [{card}]")
    print(json.dumps({"card": card, "hmma": hmma, "ab": result,
                      "per_sm": per_sm}))


if __name__ == "__main__":
    main()
