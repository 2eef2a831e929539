"""Inputs of one paged attention call, shared by the port's CPU parity tests
and its GPU tests (numpy only, so the GPU tests need no jax)."""
import numpy as np


def paged_case(b, h, kh, d, bs, nbs, lens, kq, seed, *, unmapped=True,
               dead=(), last=None, holes=()):
    """Pools and a permuted block table; slot i holds keys
    0..lens[i]+kq-2 and decodes from pos = lens[i]-1, table entries past its
    keys unmapped (-1).  ``dead`` slots hold nothing; ``last`` wraps slot
    0's ring so its keys are the ``c`` positions up to ``last``; ``holes``
    are (slot, table index) entries unmapped among mapped ones, their keys'
    positions left in ``key_pos``."""
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
    for i, ib in holes:
        bt[i, ib] = -1
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, bt=bt, key_pos=key_pos,
                pos=pos)


def poison_unread(case, window=None, value=np.nan):
    """``case`` with the pool rows that a paged kernel must not read -- the
    scratch block, blocks that no table entry maps, and keys of mapped
    blocks that no query row may see -- set to ``value``.  NaN by default:
    a key scored -inf still adds 0 x NaN = NaN to P V, so a kernel's output
    is unchanged only if it never loads those rows; a finite value shows
    only that they carry no weight."""
    kp, pos = case["key_pos"], case["pos"]
    n_pool, bs = case["k_pool"].shape[:2]
    kq, c = case["q"].shape[1], kp.shape[1]
    table = case["bt"][:, :c // bs]
    mapped = np.repeat((table >= 0) & (table < n_pool), bs, axis=1)
    seen = mapped & (kp >= 0) & (kp <= pos[:, None] + kq - 1)
    if window is not None:
        seen &= kp > pos[:, None] - window
    rows = np.repeat(np.maximum(table, 0), bs, axis=1) * bs \
        + np.arange(c) % bs
    read = np.zeros(n_pool * bs, bool)
    read[rows[seen]] = True
    out = dict(case)
    for key in ("k_pool", "v_pool"):
        out[key] = case[key].copy()
        out[key].reshape(n_pool * bs, -1)[~read] = value
    return out


def ring_case(b, h, kh, d, c, valid, seed, *, dead=(), wrap_pos=None):
    """Inputs of one contiguous-ring decode attention call: q [b, h, d] and
    rings [b, c, kh, d].  ``valid`` is one count (key_pos [c] shared by the
    rows, pos a scalar: keys 0..valid-1, decoding from valid-1) or one per
    row (key_pos [b, c], pos [b]).  ``dead`` rows hold no key.
    ``wrap_pos`` fills a ring that has wrapped: slot c holds the latest
    position <= wrap_pos that maps to it, decoding at wrap_pos -- the
    shared ring when ``valid`` is one count, row 0's ring when it is one per
    row."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, d)).astype(np.float32)
    k = r.standard_normal((b, c, kh, d)).astype(np.float32)
    v = r.standard_normal((b, c, kh, d)).astype(np.float32)
    cols = np.arange(c)
    wrapped = None
    if wrap_pos is not None:
        wrapped = (cols + (wrap_pos + 1) // c * c
                   - np.where(cols > wrap_pos % c, c, 0)).astype(np.int32)
    if wrapped is not None and np.ndim(valid) == 0:
        key_pos = wrapped
        pos = np.asarray(wrap_pos, np.int32)
    elif np.ndim(valid) == 0:
        key_pos = np.where(cols < valid, cols, -1).astype(np.int32)
        pos = np.asarray(valid - 1, np.int32)
    else:
        n = np.asarray(valid)[:, None]
        key_pos = np.where(cols[None] < n, cols[None], -1).astype(np.int32)
        pos = (np.asarray(valid) - 1).astype(np.int32)
        if wrapped is not None:
            key_pos[0], pos[0] = wrapped, wrap_pos
    if dead:
        key_pos = np.array(np.broadcast_to(key_pos, (b, c)))
        key_pos[list(dead)] = -1
        pos = np.array(np.broadcast_to(pos, (b,)))
    return dict(q=q, k_cache=k, v_cache=v, key_pos=key_pos, pos=pos)
