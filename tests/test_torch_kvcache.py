"""The port's KV cache layouts and size helpers against the JAX package."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import kvcache as JKV  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import kvcache as TKV  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.set_num_threads(2)

ARCHS = ["llama2-7b", "qwen3-0.6b", "llama2-70b"]


def _pair(arch, window=None):
    cfgs = [get_config(arch), jax_get_config(arch)]
    if window is not None:
        cfgs = [dataclasses.replace(c, pattern=tuple(
            dataclasses.replace(s, window=window) for s in c.pattern))
            for c in cfgs]
    return cfgs


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [None, 100, 4096])
@pytest.mark.parametrize("max_len,block_size", [(512, 16), (300, 16),
                                                (64, 32)])
def test_size_helpers_match(arch, window, max_len, block_size):
    tcfg, jcfg = _pair(arch, window)
    spec_t, spec_j = tcfg.pattern[0], jcfg.pattern[0]
    assert TKV.DEFAULT_BLOCK_SIZE == JKV.DEFAULT_BLOCK_SIZE
    assert TKV.attn_cache_len(spec_t, max_len) == \
        JKV.attn_cache_len(spec_j, max_len)
    assert TKV.paged_cache_len(spec_t, max_len, block_size) == \
        JKV.paged_cache_len(spec_j, max_len, block_size)
    assert TKV.max_ctx_blocks(tcfg, max_len, block_size) == \
        JKV.max_ctx_blocks(jcfg, max_len, block_size)
    assert TKV.prefix_sharing_supported(tcfg, max_len) == \
        JKV.prefix_sharing_supported(jcfg, max_len)
    for td, jd in ((torch.bfloat16, jnp.bfloat16),
                   (torch.float32, jnp.float32)):
        assert TKV.block_pool_bytes_per_block(tcfg, td) == \
            JKV.block_pool_bytes_per_block(jcfg, jd)


def _same_tree(t, j):
    assert set(t) == set(j), (sorted(t), sorted(j))
    for k in t:
        np.testing.assert_array_equal(t[k].float().numpy(),
                                      np.asarray(j[k], np.float32))
        assert tuple(t[k].shape) == tuple(j[k].shape), k


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen3-0.6b"])
def test_initial_caches_match(arch):
    """Per layer, the port's ring and paged caches equal the reference's
    (whose stacked layout carries a leading layer axis)."""
    tcfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    spec_t, spec_j = tcfg.pattern[0], jcfg.pattern[0]
    _same_tree(TKV.init_paged_block_cache(tcfg, spec_t, 3, 40, 7, 16,
                                          torch.float32),
               JKV.init_paged_block_cache(jcfg, spec_j, 3, 40, 7, 16,
                                          jnp.float32))
    _same_tree(TKV.init_block_cache(tcfg, spec_t, 2, 24, torch.float32),
               JKV.init_block_cache(jcfg, spec_j, 2, 24, jnp.float32))
    t_all = TT.init_paged_caches(tcfg, 3, 40, 7, 16, torch.float32, "cpu")
    j_all = JT.init_paged_caches(jcfg, 3, 40, 7, 16, jnp.float32)
    assert len(t_all) == tcfg.n_layers
    for i, layer in enumerate(t_all):
        _same_tree(layer, {k: v[i] for k, v in j_all["stack"]["p0"].items()})
    # the pool keeps the reference's scratch block last
    assert t_all[0]["k_pool"].shape[0] == 7 + 1


def test_unported_cache_kinds_raise():
    """A block kind the port does not know raises, as does the int8 KV
    cache; the xLSTM kinds, ported since, equal the reference's."""
    cfg = get_config("llama2-7b").reduced()
    jcfg = jax_get_config("llama2-7b").reduced()
    for kind in ("mlstm", "slstm"):
        _same_tree(TKV.init_block_cache(
            cfg, dataclasses.replace(cfg.pattern[0], kind=kind), 2, 8,
            torch.float32),
            JKV.init_block_cache(
                jcfg, dataclasses.replace(jcfg.pattern[0], kind=kind), 2, 8,
                jnp.float32))
    rec = dataclasses.replace(cfg.pattern[0], kind="mamba")
    with pytest.raises(ValueError, match="unknown block kind"):
        TKV.init_block_cache(cfg, rec, 1, 8)
    with pytest.raises(ValueError, match="int8"):
        TKV.init_paged_block_cache(dataclasses.replace(cfg, kv_dtype="int8"),
                                   cfg.pattern[0], 1, 8, 2)
