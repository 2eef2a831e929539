#!/usr/bin/env python3
"""The port's contiguous-ring decode kernel against an earlier version of
it, on one NVIDIA GPU, in one process:

    python3 scripts/ab_decode_attention.py --parent DIR

``DIR`` holds the earlier ``decode_attention.cu`` and the headers it
includes, e.g. ``git archive <commit> src/repro_torch/kernels/csrc``
unpacked, and its C entry takes the arguments it took before the ring was
split across blocks: ``decode_attention_launch(q, k, v, key_pos, pos, out,
B, H, KH, D, C, kp_stride, pos_stride, scale, softcap, window, q_dtype,
kv_dtype, stream)``.

It builds the port's kernels (printing the decode kernel's registers and
spills) and the earlier source with ``nvcc``, runs ``chip_smoke.py``'s ring
cases on the port's kernel (against the plain version, bit-identical on a
second call, masked rows never read), then at ``chip_smoke.py``'s three
decode-attention timing shapes holds the earlier kernel against the plain
version and times both kernels in turns -- earlier, port, port, earlier --
each as a CUDA graph's replay on the same inputs, beside sdpa, the plain
version and the bound.  It prints one ``ab:`` line per shape and, last, a
JSON object of the numbers.
"""
import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]

import chip_smoke as cs  # noqa: E402

SHAPES = {
    # chip_smoke.py's timing shapes: n_valid, heads (H, KH, D), ring, sets
    "llama2-7b full": (cs.CONTIGUOUS_MAX_LEN, (32, 32, 128),
                       cs.CONTIGUOUS_MAX_LEN, 3),
    "llama2-7b quarter": (cs.CONTIGUOUS_MAX_LEN // 4, (32, 32, 128),
                          cs.CONTIGUOUS_MAX_LEN, 3),
    "recurrentgemma-2b": (cs.HYBRID_WINDOW, (10, 1, 256), cs.HYBRID_WINDOW,
                          8),
}


def build_parent(src_dir: Path) -> ctypes.CDLL:
    """The earlier decode_attention.cu as a shared library of its own."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / "ab_parent" / "decode_attention_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
         str(src_dir / "decode_attention.cu")], capture_output=True,
        text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the earlier source:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    fn = lib.decode_attention_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 6 + [i] * 7 + [f, f, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def parent_call(fn, q, k_cache, v_cache, key_pos, pos):
    """One launch of the earlier kernel (bf16, no window, no softcap)."""
    b, h, d = q.shape
    c, kh = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             key_pos.data_ptr(), pos.data_ptr(), out.data_ptr(), b, h, kh, d,
             c, c if key_pos.dim() == 2 else 0, pos.dim(),
             1.0 / math.sqrt(d), 0.0, 0, 1, 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"earlier decode_attention_launch: CUDA error "
                           f"{err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory of the earlier decode_attention.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_decode_attention: needs an NVIDIA GPU")
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    built = build.build()
    parent = build_parent(args.parent)
    print(f"ab: built in {time.perf_counter() - t0:.1f} s")
    for line in built.logs.get("decode_attention.cu", "").splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(f"ab:   {line.strip()[:140]}")
    worst = cs.check_ring(da)
    print(f"ab: ring cases pass, worst error {worst:.3g}")

    result = {}
    for name, (n_valid, heads, c, n_sets) in SHAPES.items():
        sets = cs.decode_sets(n_valid, heads, c, n_sets)
        err = max(cs.compare(f"earlier kernel {name} set {i}",
                             lambda **x: parent_call(parent, **x),
                             da.decode_attention_plain, x, {},
                             torch.bfloat16)[1]
                  for i, x in enumerate(sets))
        old1 = cs.time_ms(lambda i: parent_call(parent, **sets[i]), n_sets)
        port = cs.time_decode(da, card, n_valid, heads, c, n_sets)
        new2 = cs.time_ms(lambda i: da.decode_attention(**sets[i]), n_sets)
        old2 = cs.time_ms(lambda i: parent_call(parent, **sets[i]), n_sets)
        result[name] = dict(
            parent_ms=[old1, old2], ms=[port["ms"], new2],
            library_ms=port["library_ms"], plain_ms=port["plain_ms"],
            bound_ms=port["bound_ms"], splits=list(port["splits"]),
            max_abs_err=port["max_abs_err"], parent_max_abs_err=err)
        print(f"ab: {name} S={port['splits'][0]} L={port['splits'][1]}: "
              f"earlier {old1:.4f} ms, port {port['ms']:.4f} ms, port "
              f"{new2:.4f} ms, earlier {old2:.4f} ms; sdpa "
              f"{port['library_ms']:.4f} ms, plain {port['plain_ms']:.4f} "
              f"ms, bound {port['bound_ms']:.4f} ms; max abs err port "
              f"{port['max_abs_err']:.3g}, earlier {err:.3g} [{card}]")
    print(json.dumps({"card": card, "ab": result}))


if __name__ == "__main__":
    main()
