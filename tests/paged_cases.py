"""Inputs of one paged attention call, shared by the port's CPU parity tests
and its GPU tests (numpy only, so the GPU tests need no jax)."""
import numpy as np


def paged_case(b, h, kh, d, bs, nbs, lens, kq, seed, *, unmapped=True,
               dead=(), last=None):
    """Pools and a permuted block table; slot i holds keys
    0..lens[i]+kq-2 and decodes from pos = lens[i]-1, table entries past its
    keys unmapped (-1).  ``dead`` slots hold nothing; ``last`` wraps slot
    0's ring so its keys are the ``c`` positions up to ``last``."""
    r = np.random.default_rng(seed)
    c = nbs * bs
    n_blocks = b * nbs + 2
    k_pool = r.standard_normal((n_blocks + 1, bs, kh, d)).astype(np.float32)
    v_pool = r.standard_normal((n_blocks + 1, bs, kh, d)).astype(np.float32)
    q = r.standard_normal((b, kq, h, d)).astype(np.float32)
    bt = r.permutation(n_blocks)[:b * nbs].reshape(b, nbs).astype(np.int32)
    n_keys = np.asarray(lens) + kq - 1
    cols = np.arange(c)[None]
    key_pos = np.where(cols < n_keys[:, None], cols, -1).astype(np.int32)
    pos = (np.asarray(lens) - 1).astype(np.int32)
    if last is not None:
        key_pos[0] = last - (last - np.arange(c)) % c
        pos[0] = last - kq + 1
    if unmapped:
        used = -(-(key_pos.max(axis=1) + 1) // bs)
        bt[np.arange(nbs)[None] >= np.minimum(used, nbs)[:, None]] = -1
    for i in dead:
        bt[i], key_pos[i] = -1, -1
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, bt=bt, key_pos=key_pos,
                pos=pos)
