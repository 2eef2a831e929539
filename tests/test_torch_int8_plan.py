"""The int8 matmul kernel's tile plan, on the CPU: ``int8_matmul.tile_plan``
computes from the shapes and the SM count alone the rows per block, the K
splits and the grid that ``csrc/int8_matmul.cu`` launches.  These tests hold
the plan to its rules (every split non-empty and long enough, K per split a
whole number of stages, CUDA's grid limits, two blocks per SM at llama2-7b's
decode projections), the float32 plan to the one its kernel has always been
given, and the plan's tile constants to the kernel source's.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import int8_matmul as I8  # noqa: E402

H100_SMS = 132
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# (M, K, N): the JAX int8 test's shapes, the ragged GPU-test shapes, llama2-7b
# projections at decode and prefill, and the masked, plan-boundary shapes
SHAPES = [(128, 512, 128), (70, 300, 130), (1, 1024, 256), (256, 64, 64),
          (5, 7, 3), (4, 11008, 4096), (16, 4104, 4100), (17, 4104, 4100),
          (130, 4104, 4100), (1, 530, 64), (8192, 4096, 11008),
          (3, 100_000, 128)]
# llama2-7b's projections (K x N): q/k/v/o, gate/up, down
PROJ = [(4096, 4096), (4096, 11008), (11008, 4096)]


def _kernel_chunk(k, splits, bk):
    """What the kernel's launch derives from ``splits``: K per split and the
    non-empty splits (``launch_split`` in ``csrc/int8_matmul.cu``)."""
    k_chunk = (k + splits - 1) // splits
    k_chunk = (k_chunk + bk - 1) // bk * bk
    return k_chunk, (k + k_chunk - 1) // k_chunk


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tile_plan_cuts_k_into_whole_stages(m, k, n, dtype):
    plan = I8.tile_plan(m, k, n, H100_SMS, DTYPES[dtype])
    small, large, bk = I8.TILES[DTYPES[dtype]]
    assert plan.rows == (small if m <= I8.SMALL_M else large)
    assert plan.k_chunk % bk == 0
    assert _kernel_chunk(k, plan.splits, bk) == (plan.k_chunk, plan.grid[2])
    used = plan.grid[2]
    lengths = [min(k, z * plan.k_chunk + plan.k_chunk) - z * plan.k_chunk
               for z in range(used)]
    assert sum(lengths) == k and all(n_k > 0 for n_k in lengths)
    if used > 1:
        assert min(lengths) >= I8._MIN_SPLIT_K
    assert plan.grid[:2] == (-(-n // I8.BN), -(-m // plan.rows))
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("k,n", PROJ)
def test_tile_plan_fills_the_card_at_decode(k, n, m, dtype):
    """At a decode step the output tiles alone are a few dozen blocks: K is
    split until the grid holds at least two blocks per SM."""
    plan = I8.tile_plan(m, k, n, H100_SMS, DTYPES[dtype])
    assert plan.rows == 16
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks >= 2 * H100_SMS and plan.grid[2] > 1


@pytest.mark.parametrize("m,k,n,want", [
    # (splits, k_chunk, grid) the float32 kernel was given before the
    # bfloat16 path moved to the tensor cores: its outputs keep their bits
    (4, 4096, 4096, (9, 464, (32, 1, 9))),
    (4, 4096, 11008, (4, 1024, (86, 1, 4))),
    (4, 11008, 4096, (9, 1232, (32, 1, 9))),
    (8192, 4096, 4096, (1, 4096, (32, 128, 1))),
    (8192, 4096, 11008, (1, 4096, (86, 128, 1))),
    (8192, 11008, 4096, (1, 11008, (32, 128, 1))),
])
def test_float32_plan_at_the_timing_shapes(m, k, n, want):
    plan = I8.tile_plan(m, k, n, H100_SMS, torch.float32)
    assert (plan.splits, plan.k_chunk, plan.grid) == want


@pytest.mark.parametrize("m,rows", [(8192, 128), (16, 16), (17, 128)])
def test_bfloat16_rows_per_block(m, rows):
    assert I8.tile_plan(m, 4096, 4096, H100_SMS).rows == rows


def test_tile_plan_refuses_more_row_tiles_than_cuda_takes():
    with pytest.raises(ValueError, match="65535"):
        I8.tile_plan(65536 * 128, 64, 64, H100_SMS)
    with pytest.raises(ValueError, match="65535"):
        I8.tile_plan(65536 * 64, 64, 64, H100_SMS, torch.float32)


def test_tile_constants_match_the_kernel_source():
    """The plan's BN, SMALL_M and TILES are the constants the kernel's launch
    uses (the source ties ``kF32Tiles`` to the float32 kernel's ``Tiles``
    by a static_assert)."""
    src = (Path(I8.__file__).parent / "csrc" / "int8_matmul.cu").read_text()

    def const(name):
        found = re.findall(rf"constexpr int {name}(?!\w)[^=]*= ([^;]+);",
                           src)
        assert len(found) == 1, name
        return found[0]

    def tiles(name):
        values = re.fullmatch(r"\{(\w+), (\w+), (\w+)\}",
                              const(name)).groups()
        return tuple(int(const(v)) if v.startswith("k") else int(v)
                     for v in values)

    assert int(const("kBN")) == I8.BN
    assert int(const("kSmallM")) == I8.SMALL_M
    assert tiles(r"kBf16Tiles\[3\]") == I8.TILES[torch.bfloat16]
    assert tiles(r"kF32Tiles\[3\]") == I8.TILES[torch.float32]
