#!/usr/bin/env python3
"""The port's flash-attention kernel against an earlier version of it, on
one NVIDIA GPU, in one process:

    python3 scripts/ab_flash_attention.py --parent DIR [--p-parts N ...]

``DIR`` holds the earlier ``flash_attention.cu`` and the headers it
includes, e.g. ``git archive <commit> src/repro_torch/kernels/csrc``
unpacked.  Its C entry, ``flash_attention_launch(q, k, v, out, B, S, H, KH,
D, scale, softcap, window, q_dtype, kv_dtype, stream)``, is the port's.

It builds the port's kernels (printing the flash kernel's registers and
spills, and how many HMMA instructions each instance's SASS holds) and the
earlier source with ``nvcc``, runs ``chip_smoke.py``'s flash cases on the
port's kernel (against the plain version, within one bf16 step, a second
call bit-identical) and counts the float32 cases whose output is bit for
bit the earlier kernel's, then at three bf16 shapes -- llama2-7b's and
recurrentgemma-2b's score phase per sequence and qwen3-0.6b's train batch
-- holds the earlier kernel against the plain version and times both in
turns -- earlier, port, port, earlier -- each as a CUDA graph's replay on
inputs larger than the L2, beside sdpa, the plain version and the bound.

``--p-parts N ...`` also builds the port's source with P split into N bf16
parts instead of ``kPParts`` (N = 1: one bf16 P in the P V product) and
times each after the port at each shape; their errors are reported, not
asserted: the largest against the plain version, and how many outputs lie
more than one bf16 step from the float64 result.

It prints one ``ab:`` line per shape and kernel, and, last, a JSON object
of the numbers.
"""
import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402

SHAPES = {
    # name: B, S, heads (H, KH, D), window, input sets (together > the L2)
    "llama2-7b 1 x 4096 causal": (1, cs.SCORE_LEN, (32, 32, 128), None, 2),
    f"{cs.HYBRID} 1 x 4096 window {cs.HYBRID_WINDOW}":
        (1, cs.SCORE_LEN, (10, 1, 256), cs.HYBRID_WINDOW, 3),
    f"{cs.TRAIN_ARCH} {cs.TRAIN_BATCH} x {cs.TRAIN_LEN} causal":
        (cs.TRAIN_BATCH, cs.TRAIN_LEN, (16, 8, 128), None, 4),
}


def build_lib(src: Path, name: str):
    """``src`` (a flash_attention.cu beside its headers) as a shared library
    of its own; returns the typed C entry and nvcc's register report."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / "ab_flash" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = ctypes.CDLL(str(out)).flash_attention_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 4 + [i] * 5 + [f, f, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn, proc.stdout + proc.stderr


def parts_source(n: int) -> Path:
    """The port's flash_attention.cu with P in ``n`` bf16 parts, beside a
    copy of its headers."""
    from repro_torch.kernels import build
    d = build.BUILD_DIR.parent / "ab_flash" / f"p_parts_{n}"
    d.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    src, k = re.subn(r"constexpr int kPParts = \d+;",
                     f"constexpr int kPParts = {n};",
                     (build.CSRC / "flash_attention.cu").read_text())
    if k != 1:
        raise RuntimeError("no kPParts in flash_attention.cu")
    (d / "flash_attention.cu").write_text(src)
    return d / "flash_attention.cu"


def call(fn, q, k, v, window=None, softcap=None):
    """One launch of a built flash_attention_launch."""
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    code = int(q.dtype == torch.bfloat16)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
             h, k.shape[2], d, 1.0 / math.sqrt(d), float(softcap or 0.0),
             int(window or 0), code, code,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_launch: CUDA error {err}")
    return out


def report(log: str, label: str):
    for line in log.splitlines():
        if "flash_attention_kernel" in line and "Compiling entry" in line \
                or "registers" in line or "spill" in line:
            print(f"ab: {label}:   {line.strip()[:140]}")


def hmma_counts(lib: Path):
    """HMMA instructions in the SASS of each flash_attention_kernel
    instance of ``lib``, by cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "flash_attention_kernel" in name:
            demangled = subprocess.run(["c++filt", name], capture_output=True,
                                       text=True).stdout.strip() or name
            short = re.sub(r".*flash_attention_kernel<(.*)>.*", r"\1",
                           demangled)
            counts[short] = part.count("HMMA")
    return counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory of the earlier flash_attention.cu")
    ap.add_argument("--p-parts", type=int, nargs="*", default=[],
                    help="also time the port with P in this many bf16 parts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_flash_attention: needs an NVIDIA GPU")
    from flash_reference import bf16_steps_apart, flash_attention_f64
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    built = build.build()
    print(f"ab: built in {time.perf_counter() - t0:.1f} s, flash_attention.cu"
          f" {built.seconds.get('flash_attention.cu', 0.0):.1f} s")
    report(built.logs.get("flash_attention.cu", ""), "port")
    hmma = hmma_counts(built.path)
    print(f"ab: HMMA instructions per flash_attention_kernel instance: "
          f"{hmma}")
    bf16 = [n for key, n in hmma.items() if "bfloat16" in key]
    if len(bf16) != len(fa.HEAD_DIMS) or not all(bf16):
        raise AssertionError("a bf16 flash instance runs no HMMA")
    others = {"parent": build_lib(args.parent / "flash_attention.cu",
                                  "parent")}
    for n in args.p_parts:
        others[f"p_parts_{n}"] = build_lib(parts_source(n), f"p_parts_{n}")
    for label, (_, log) in others.items():
        report(log, label)
    worst = cs.check_flash(fa)
    print(f"ab: flash cases pass, worst error {worst:.3g}")
    same = 0
    for i, (name, shape, opts) in enumerate(cs.FLASH_CASES):
        opts = dict(opts)
        x = cs.flash_inputs(*shape, seed=700 + i, dtype=torch.float32,
                            q_scale=opts.pop("q_scale", 1.0))
        same += torch.equal(call(others["parent"][0], **x, **opts),
                            fa.flash_attention(**x, **opts))
    print(f"ab: float32: {same} of {len(cs.FLASH_CASES)} flash cases bit for "
          f"bit the earlier kernel's output")

    result = {"hmma": hmma, "float32_cases_bit_identical": same}
    for name, (b, s, heads, window, n_sets) in SHAPES.items():
        sets = cs.flash_sets(b, s, heads, n_sets)
        errs = {label: [0.0, 0] for label in others}
        for x in sets:
            want = fa.flash_attention_plain(**x, window=window)
            exact = flash_attention_f64(**x, window=window)
            for label, (fn, _) in others.items():
                got = call(fn, **x, window=window)
                if label == "parent":   # the earlier kernel must agree too
                    torch.testing.assert_close(
                        got.float(), want.float(), **cs.TOL["bfloat16"],
                        msg=lambda m: f"earlier kernel {name}: {m}")
                errs[label][0] = max(errs[label][0],
                                     (got.float() - want.float()).abs().max()
                                     .item())
                errs[label][1] += bf16_steps_apart(got, exact)
        parent = others["parent"][0]
        old1 = cs.time_ms(lambda i: call(parent, **sets[i], window=window),
                          n_sets, iters=20, warmup=2)
        port = cs.time_flash(fa, card, heads, window, n_sets, b, s)
        row = dict(ms=[port["ms"]], library_ms=port["library_ms"],
                   plain_ms=port["plain_ms"], bound_ms=port["bound_ms"],
                   tiles=list(port["tiles"]), max_abs_err=port["max_abs_err"],
                   parent_max_abs_err=errs["parent"][0],
                   parent_beyond_one_step=errs["parent"][1])
        for n in args.p_parts:
            fn, label = others[f"p_parts_{n}"][0], f"p_parts_{n}"
            row[label] = dict(
                ms=cs.time_ms(lambda i: call(fn, **sets[i], window=window),
                              n_sets, iters=20, warmup=2),
                max_abs_err=errs[label][0], beyond_one_step=errs[label][1])
        row["ms"].append(cs.time_ms(
            lambda i: fa.flash_attention(**sets[i], window=window), n_sets,
            iters=20, warmup=2))
        old2 = cs.time_ms(lambda i: call(parent, **sets[i], window=window),
                          n_sets, iters=20, warmup=2)
        row["parent_ms"] = [old1, old2]
        result[name] = row
        print(f"ab: {name}: earlier {old1:.4f} ms, port {row['ms'][0]:.4f} "
              f"ms, port {row['ms'][1]:.4f} ms, earlier {old2:.4f} ms; sdpa "
              f"{port['library_ms']:.4f} ms, plain {port['plain_ms']:.4f} "
              f"ms, bound {port['bound_ms']:.4f} ms; max abs err port "
              f"{port['max_abs_err']:.3g}, earlier {errs['parent'][0]:.3g}; "
              f"tiles masked/unmasked {port['tiles'][0]}/{port['tiles'][1]} "
              f"[{card}]")
        for n in args.p_parts:
            r = row[f"p_parts_{n}"]
            print(f"ab: {name}: P in {n} bf16 parts {r['ms']:.4f} ms, max abs "
                  f"err {r['max_abs_err']:.3g}, {r['beyond_one_step']} outputs "
                  f"beyond one bf16 step of float64 [{card}]")
    print(json.dumps({"card": card, "ab": result}))


if __name__ == "__main__":
    main()
