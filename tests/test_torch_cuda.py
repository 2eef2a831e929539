"""The port on an NVIDIA GPU: the paged attention kernel against its plain
version, the wrapper's checks, and the served model through the kernel
against the gather path.  Every test is marked ``cuda`` and skips without a
GPU (a CUDA kernel has no CPU or interpret mode).  The file imports no jax,
so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paged_cases import paged_case  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.runtime import TorchTensorBackend  # noqa: E402
from repro_torch.serving import LLM, SamplingParams  # noqa: E402

pytestmark = pytest.mark.cuda

# float32: the JAX kernel tests' tolerance.  bfloat16: both sides round the
# float32 result once to bf16 after summing in another order, so a result
# may land on the neighbouring bf16 value, one step of 2**-7 relative.
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernel has no CPU "
                    "or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(x, dev, dtype=torch.float32):
    t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    for k in ("q", "k_pool", "v_pool"):
        t[k] = t[k].to(dtype)
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(gpu, dtype):
    """The CUDA kernel against its plain version on the card (GQA, KQ=4,
    unmapped tail blocks, softcap, a dead row)."""
    x = paged_case(3, 16, 8, 128, 16, 8, (40, 100, 7), 4, seed=40, dead=(2,))
    t = _on(x, gpu, getattr(torch, dtype))
    before = PA.paged_attention.launches
    got = PA.paged_attention(**t, softcap=30.0)
    want = PA.paged_attention_plain(**t, softcap=30.0)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert bool((got[2] == 0).all())


def test_wrapper_raises_on_what_the_kernel_does_not_take(gpu):
    """No fallback to the plain version: wrong dtypes, strides, devices or
    head dims raise before any launch."""
    t = _on(paged_case(2, 4, 2, 64, 16, 4, (40, 25), 1, seed=41), gpu)
    q = t["q"][:, 0]
    args = (t["k_pool"], t["v_pool"], t["bt"], t["key_pos"], t["pos"])
    before = PA.paged_attention.launches
    bad = [
        (q.half(), *args),                                   # float16
        (q, *args[:2], args[2].long(), *args[3:]),           # int64 table
        (q.transpose(1, 2).contiguous().transpose(1, 2), *args),  # strides
        (q.cpu(), *args),                                    # two devices
        (q[..., :48].contiguous(), *(a[..., :48].contiguous()
                                     for a in args[:2]), *args[2:]),  # D=48
    ]
    for call in bad:
        with pytest.raises(ValueError):
            PA.paged_attention(*call)
    assert PA.paged_attention.launches == before


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-0.6b"])
def test_served_tokens_kernel_equals_gather_path(gpu, arch):
    """Reduced model in float32 on the card: greedy tokens through
    ``LLM.generate`` are the same with the kernel (``impl="cuda"``) and the
    gather path (``impl="ref"``); the kernel launches once per layer and
    decode step."""
    cfg = get_config(arch).reduced(n_layers=3)
    params = init_params(cfg, torch.Generator(device=gpu).manual_seed(0), gpu)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17, 9)]
    sp = SamplingParams(max_tokens=12)
    outs = {}
    for impl in ("cuda", "ref"):
        be = TorchTensorBackend(cfg, params, n_slots=3, max_len=64, impl=impl,
                                block_size=16)
        steps = []
        decode = be.decode_step
        be.decode_step = lambda feeds: steps.append(1) or decode(feeds)
        before = PA.paged_attention.launches
        outs[impl] = [o.tokens for o in LLM.from_backend(be).generate(
            prompts, sp)]
        launched = PA.paged_attention.launches - before
        assert launched == (cfg.n_layers * len(steps) if impl == "cuda"
                            else 0)
        assert be.info.attn_impl == impl
    assert outs["cuda"] == outs["ref"]
