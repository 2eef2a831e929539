#!/usr/bin/env python3
"""The port's RG-LRU scan kernel against an earlier version of it, on one
NVIDIA GPU, in one process:

    python3 scripts/ab_rglru_scan.py --parent DIR [--plans 64x4x4 32x4x2 ...]
        [--also 1x4096 3x4096 ...]

``DIR`` holds the earlier ``rglru_scan.cu``, e.g. ``git archive <commit>
src/repro_torch/kernels/csrc`` unpacked.  The earlier entry takes no plan:
``rglru_scan_launch(log_a, b, h0, out, B, S, R, stream)``.

It builds the port's kernels and the earlier source with ``nvcc``, all at
once, and prints each scan kernel's registers and shared memory from the
``-Xptxas -v`` reports.  It runs ``chip_smoke.py``'s scan checks on the
port's kernel (against the plain version, left pads bit for bit), then
requires the port's outputs bit for bit the earlier kernel's
(``torch.equal``) at every input of those checks -- ``RGLRU_CASES`` with
R % 4 != 0 and misaligned bases, the left-pad inputs and their unpadded
rows -- and at every input set of the timing shapes.  At the serve's
4 x 4096 x 2560, the score's 2 x 4096 x 2560 and the short wave's
4 x 256 x 2560 (float32, inputs past the L2) it times earlier, port, port,
earlier, each as a CUDA graph's replay, beside the bound, the plain version
and the plan.  ``--plans STEPSxSTAGESxWARPS ...`` also times the port's
kernel under other plans (steps a stage, stages, copy warps) at those
shapes, their outputs held bit for bit too; ``--also BxS ...`` times more
shapes (B slots x S steps x 2560) the same way.  It
prints one ``ab:`` line per shape and, last, a JSON object of the numbers.
"""
import argparse
import ctypes
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402

# (B, S): the hybrid serve's longest wave, its score, its short wave
SHAPES = {"serve 4 x 4096 x 2560": (cs.SLOTS, cs.HYBRID_MAX_LEN),
          "score 2 x 4096 x 2560": (cs.SCORE_BATCH, cs.SCORE_LEN),
          "short 4 x 256 x 2560": (cs.SLOTS, 256)}


def parent_entry(src_dir: Path, pool):
    """The earlier scan source, built in ``pool`` while the caller builds
    the port; returns a job whose result is the typed entry and the
    compiler's report."""
    from repro_torch.kernels import build

    def run():
        (lib, log), = build.build_each(
            {"rglru_scan": src_dir / "rglru_scan.cu"},
            build.BUILD_DIR.parent / "ab_parent").values()
        fn = lib.rglru_scan_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 3 + [p]
        fn.restype = ctypes.c_int
        return fn, log
    return pool.submit(run)


def parent_scan(fn, log_a, b, h0=None):
    """One launch of the earlier kernel."""
    out = torch.empty_like(log_a)
    bb, s, r = log_a.shape
    err = fn(log_a.data_ptr(), b.data_ptr(),
             None if h0 is None else h0.data_ptr(), out.data_ptr(), bb, s, r,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier rglru_scan_launch: CUDA error {err}")
    return out


def planned_scan(rs, steps, stages, copy_warps, log_a, b, h0=None):
    """One launch of the port's kernel under another plan (steps a stage,
    stages, copy warps), the copy width as ``scan_plan`` picks it."""
    out = torch.empty_like(log_a)
    bb, s, r = log_a.shape
    aligned = log_a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    rs._launch(log_a.device, log_a.data_ptr(), b.data_ptr(),
               None if h0 is None else h0.data_ptr(), out.data_ptr(), bb, s,
               r, rs.STRIP, steps, min(stages, -(-s // steps)),
               4 if aligned and r % 4 == 0 else 1, copy_warps)
    return out


def report_lines(log):
    """The compiler's registers and shared memory of each scan kernel."""
    keep, scan = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            scan = "rglru_scan_kernel" in line
            if scan:
                keep.append(line.split("'")[1] if "'" in line else line)
        elif scan and ("registers" in line or "spill" in line):
            keep.append("  " + line.split(":", 1)[-1].strip())
    return keep


def same_bits(what, fns, x):
    """Every function of ``fns`` gives the port's bits on ``x``."""
    want = fns["port"](**x)
    for name, fn in fns.items():
        if not torch.equal(fn(**x), want):
            raise AssertionError(f"{what}: the {name} kernel's output is "
                                 f"not the port's, bit for bit")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory of the earlier kernel source")
    ap.add_argument("--plans", nargs="*", default=[],
                    help="other plans of the port's kernel to time, "
                         "STEPSxSTAGESxWARPS (e.g. 64x4x4)")
    ap.add_argument("--also", nargs="*", default=[],
                    help="more shapes to time, BxS at R = 2560 (e.g. "
                         "1x4096)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_rglru_scan: needs an NVIDIA GPU")
    plans = [tuple(int(v) for v in p.split("x")) for p in args.plans]
    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as rs
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        job = parent_entry(args.parent, pool)
        build.build()
        parent, earlier_log = job.result()
    print(f"ab: built in {time.perf_counter() - t0:.1f} s")
    for what, log in (("port", build.compiler_logs()["rglru_scan.cu"]),
                      ("earlier", earlier_log)):
        for line in report_lines(log):
            print(f"ab: {what}: {line}")
    worst = cs.check_rglru(rs)
    print(f"ab: scan checks pass, worst error {worst:.3g}")

    port_fn = rs.rglru_scan

    def earlier_fn(**x):
        return parent_scan(parent, **x)
    others = {"x".join(map(str, plan)): (
        lambda pl: lambda **x: planned_scan(rs, *pl, **x))(plan)
        for plan in plans}
    fns = {"port": port_fn, "earlier": earlier_fn,
           **{f"plan {k}": fn for k, fn in others.items()}}
    n_checked = 0
    for i in range(len(cs.RGLRU_CASES)):
        same_bits(f"case {cs.RGLRU_CASES[i]}", fns,
                  cs.rglru_case_inputs(i))
        n_checked += 1
    for k, (r, offset) in enumerate(cs.RGLRU_PAD_CASES):
        x = cs.rglru_pad_inputs(k)
        same_bits(f"left pads R={r} offset {offset}", fns, x)
        for row, p in enumerate(cs.RGLRU_PADS):
            same_bits(f"left pads R={r} offset {offset} row {row} "
                      f"unpadded", fns,
                      dict(log_a=x["log_a"][row:row + 1, p:].contiguous(),
                           b=x["b"][row:row + 1, p:].contiguous(),
                           h0=x["h0"][row:row + 1]))
            n_checked += 1
        n_checked += 1
    print(f"ab: {n_checked} check inputs: the port's outputs bit for bit "
          f"the earlier kernel's" + (f" and plans {list(others)}" if plans
                                     else ""))

    result = {}
    shapes = dict(SHAPES)
    for shape in args.also:
        b, s = (int(v) for v in shape.split("x"))
        shapes[f"{b} x {s} x 2560"] = (b, s)
    for name, (b, s) in shapes.items():
        sets = cs.rglru_sets(b, s)
        n = len(sets)
        for i, x in enumerate(sets):
            same_bits(f"{name} set {i}", fns, x)
        old1 = cs.time_ms(lambda i: earlier_fn(**sets[i]), n, iters=50)
        port = cs.time_rglru(rs, card, s, b=b)
        new2 = cs.time_ms(lambda i: port_fn(**sets[i]), n, iters=50)
        old2 = cs.time_ms(lambda i: earlier_fn(**sets[i]), n, iters=50)
        other = {k: cs.time_ms(lambda i, fn=fn: fn(**sets[i]), n, iters=50)
                 for k, fn in others.items()}
        bound_ms = port["bound_ms"]
        result[name] = dict(parent_ms=[old1, old2], ms=[port["ms"], new2],
                            plain_ms=port["plain_ms"], bound_ms=bound_ms,
                            bound_by=port["bound_by"], plan=port["plan"],
                            n_sets=n, bit_identical=True, other_plans=other,
                            max_abs_err=port["max_abs_err"])
        best = min(port["ms"], new2)
        print(f"ab: {name}: {n} sets bit for bit; earlier {old1:.4f} ms, "
              f"port {port['ms']:.4f} ms, port {new2:.4f} ms, earlier "
              f"{old2:.4f} ms; bound {bound_ms:.4f} ms ({port['bound_by']}; "
              f"port at {bound_ms / best:.1%} of it, earlier at "
              f"{bound_ms / min(old1, old2):.1%}); plain "
              f"{port['plain_ms']:.4f} ms; {port['plan']}"
              + "".join(f"; plan {k} {v:.4f} ms" for k, v in other.items())
              + f" [{card}]")
    print(json.dumps({"card": card, "ab": result}))


if __name__ == "__main__":
    main()
