#!/usr/bin/env python3
"""The port's paged attention kernel against an earlier version of it, on
one NVIDIA GPU, in one process:

    python3 scripts/ab_paged_attention.py --parent DIR

``DIR`` holds the earlier ``paged_attention.cu`` and ``decode_attention.cu``
and the headers they include, e.g. ``git archive <commit>
src/repro_torch/kernels/csrc`` unpacked.  The earlier paged entry takes the
arguments it took before each slot's table was split across blocks:
``paged_attention_launch(q, k_pool, v_pool, bt, key_pos, pos, out, B, KQ,
H, KH, D, bs, nbs, bt_stride, n_pool_blocks, scale, softcap, window,
q_dtype, kv_dtype, stream)``; the earlier decode entry is the port's.

It builds the port's kernels and the two earlier sources with ``nvcc``,
all at once (printing every ``paged_attention`` instance's registers and
spills from the ``-Xptxas -v`` report of the port's build, the earlier
source's beside them), and runs ``chip_smoke.py``'s paged cases on the
port's kernel (against the plain version, bit-identical on a second call,
unread pool rows poisoned with NaN without effect, row i of a KQ=4 call
equal to the KQ=1 call at pos + i). At ``chip_smoke.py``'s three paged
timing shapes it holds the earlier kernel against the plain version and
times both in turns -- earlier, port, port, earlier -- each as a CUDA
graph's replay on inputs larger than the L2, beside sdpa, the plain
version and the bound, and prints the split plan and grid. Last, the
contiguous-ring kernel, which shares the header: at ``chip_smoke.py``'s
three decode timing shapes the earlier and the port's
``decode_attention_launch``, called with the same arguments, must give the
same bits, and are timed in turns. It prints one ``ab:`` line per shape
and, last, a JSON object of the numbers.
"""
import argparse
import ctypes
import json
import math
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402

PAGED_SHAPES = {
    # chip_smoke.py's timing shapes: query tokens per slot, keys per slot
    f"KQ=1, {cs.MAX_LEN} keys (paged serve)": (1, cs.MAX_LEN),
    f"KQ={cs.SPEC_K}, {cs.MAX_LEN} keys (spec serve)": (cs.SPEC_K,
                                                         cs.MAX_LEN),
    f"KQ=1, {cs.STREAM_MAX_LEN} keys (streamed serve)": (1,
                                                         cs.STREAM_MAX_LEN),
}
DECODE_SHAPES = {
    # chip_smoke.py's timing shapes: n_valid, heads (H, KH, D), ring, sets
    "llama2-7b full": (cs.CONTIGUOUS_MAX_LEN, (32, 32, 128),
                       cs.CONTIGUOUS_MAX_LEN, 3),
    "llama2-7b quarter": (cs.CONTIGUOUS_MAX_LEN // 4, (32, 32, 128),
                          cs.CONTIGUOUS_MAX_LEN, 3),
    "recurrentgemma-2b": (cs.HYBRID_WINDOW, (10, 1, 256), cs.HYBRID_WINDOW,
                          8),
}


def start_builds(src_dir: Path, pool):
    """The earlier paged and decode sources, one library each, built in
    ``pool`` while the caller builds the port; awaited by
    :func:`parent_entries`."""
    from repro_torch.kernels import build
    return pool.submit(build.build_each,
                       {stem: src_dir / f"{stem}.cu"
                        for stem in ("paged_attention", "decode_attention")},
                       build.BUILD_DIR.parent / "ab_parent")


def parent_entries(job):
    """The earlier entry points, typed, and the earlier paged source's
    compiler report."""
    libs = job.result()
    fns = {name: getattr(lib, f"{name}_launch")
           for name, (lib, _) in libs.items()}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns["paged_attention"].argtypes = [p] * 7 + [i] * 9 + [f, f, i, i, i, p]
    fns["decode_attention"].argtypes = [p] * 8 + [i] * 9 + [f, f, i, i, i, p]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns, libs["paged_attention"][1]


def parent_paged(fn, q, k_pool, v_pool, bt, key_pos, pos):
    """One launch of the earlier paged kernel (bf16, no window, no
    softcap)."""
    q4 = q if q.dim() == 4 else q[:, None]
    b, kq, h, d = q4.shape
    n_pool, bs, kh = k_pool.shape[:3]
    c = key_pos.shape[1]
    out = torch.empty_like(q4)
    err = fn(q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             bt.data_ptr(), key_pos.data_ptr(), pos.data_ptr(),
             out.data_ptr(), b, kq, h, kh, d, bs, c // bs, bt.stride(0),
             n_pool, 1.0 / math.sqrt(d), 0.0, 0, 1, 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier paged_attention_launch: CUDA error "
                           f"{err}")
    return out if q.dim() == 4 else out[:, 0]


class ParentEntry:
    """The earlier decode entry behind the port's wrapper, which then
    passes it exactly the arguments it passes the port's entry."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, device, *args):
        err = self.fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"earlier decode_attention_launch: CUDA "
                               f"error {err}")


def parent_decode(da, entry, **x):
    port_entry, da._launch = da._launch, entry
    try:
        return da.decode_attention(**x)
    finally:
        da._launch = port_entry


def instance_lines(log):
    """The compiler's registers and spills of each paged_attention
    instance (kernel and merge kernel)."""
    keep, paged = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = re.search(r"paged_attention_(?:merge_)?kernelI\w+", line)
            paged = name is not None
            if paged:
                keep.append(name.group(0))
        elif paged and ("registers" in line or "spill" in line):
            keep.append("  " + line.split(":", 1)[-1].strip())
    return keep


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory of the earlier kernel sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_paged_attention: needs an NVIDIA GPU")
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        job = start_builds(args.parent, pool)
        build.build()
        parents, earlier_log = parent_entries(job)
    print(f"ab: built in {time.perf_counter() - t0:.1f} s")
    for what, log in (("port", build.compiler_logs()["paged_attention.cu"]),
                      ("earlier", earlier_log)):
        for line in instance_lines(log):
            print(f"ab: {what}: {line}")
    worst = cs.check_paged(pa)
    print(f"ab: paged cases pass, worst error {worst:.3g}")

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for name, (kq, max_len) in PAGED_SHAPES.items():
        sets = cs.paged_sets(kq, max_len)
        err = max(cs.compare(f"earlier kernel {name} set {i}",
                             lambda **x: parent_paged(
                                 parents["paged_attention"], **x),
                             pa.paged_attention_plain, x, {},
                             torch.bfloat16)[1]
                  for i, x in enumerate(sets))
        n = len(sets)
        old1 = cs.time_ms(lambda i: parent_paged(
            parents["paged_attention"], **sets[i]), n)
        port = cs.time_paged(pa, card, kq, max_len)
        new2 = cs.time_ms(lambda i: pa.paged_attention(**sets[i]), n)
        old2 = cs.time_ms(lambda i: parent_paged(
            parents["paged_attention"], **sets[i]), n)
        x = sets[0]
        b, h = x["q"].shape[0], x["q"].shape[-2]
        kh = x["k_pool"].shape[2]
        s, L = port["splits"]
        chunks = -(-kq * (h // kh) // da.ROWS_PER_BLOCK)
        result[name] = dict(
            parent_ms=[old1, old2], ms=[port["ms"], new2],
            library_ms=port["library_ms"], plain_ms=port["plain_ms"],
            bound_ms=port["bound_ms"], splits=[s, L],
            grid=[kh, b, s * chunks], max_abs_err=port["max_abs_err"],
            parent_max_abs_err=err)
        print(f"ab: paged {name} S={s} L={L} grid ({kh}, {b}, {s * chunks}) "
              f"on {n_sm} SMs: earlier {old1:.4f} ms, port {port['ms']:.4f} "
              f"ms, port {new2:.4f} ms, earlier {old2:.4f} ms; sdpa "
              f"{port['library_ms']:.4f} ms, plain {port['plain_ms']:.4f} "
              f"ms, bound {port['bound_ms']:.4f} ms; max abs err port "
              f"{port['max_abs_err']:.3g}, earlier {err:.3g} [{card}]")

    entry = ParentEntry(parents["decode_attention"])
    for name, (n_valid, heads, c, n_sets) in DECODE_SHAPES.items():
        sets = cs.decode_sets(n_valid, heads, c, n_sets)
        for i, x in enumerate(sets):
            if not torch.equal(da.decode_attention(**x),
                               parent_decode(da, entry, **x)):
                raise AssertionError(f"decode {name} set {i}: the port's "
                                     f"output is not the earlier kernel's")
        old1 = cs.time_ms(lambda i: parent_decode(da, entry, **sets[i]),
                          n_sets)
        new1 = cs.time_ms(lambda i: da.decode_attention(**sets[i]), n_sets)
        new2 = cs.time_ms(lambda i: da.decode_attention(**sets[i]), n_sets)
        old2 = cs.time_ms(lambda i: parent_decode(da, entry, **sets[i]),
                          n_sets)
        result[f"decode {name}"] = dict(parent_ms=[old1, old2],
                                        ms=[new1, new2], bit_identical=True)
        print(f"ab: decode {name}: outputs bit-identical to the earlier "
              f"kernel's over {n_sets} sets; earlier {old1:.4f} ms, port "
              f"{new1:.4f} ms, port {new2:.4f} ms, earlier {old2:.4f} ms "
              f"[{card}]")
    print(json.dumps({"card": card, "ab": result}))


if __name__ == "__main__":
    main()
