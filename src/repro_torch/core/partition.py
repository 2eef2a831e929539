"""Joint device selection + model partition (paper §IV, Algos. 1 & 2).

All solvers consume a plain-array :class:`PartitionProblem` so they are
testable against brute-force references and hypothesis-generated instances:

- :func:`solve_latency`        — Algo. 1 (latency DP, sequential inference)
- :func:`solve_throughput`     — Algo. 2 (throughput DP, pipeline inference),
  exact bitmask DP for small M, symmetric-device collapsed DP for clusters of
  interchangeable devices (the paper's 12xAGX testbed), beam fallback.
- :func:`brute_force_latency` / :func:`brute_force_throughput` — exact
  references used by the test-suite.
- :func:`even_partition`, :func:`cloud_edge_plans` — the paper's baselines
  (EdgeShard-Even, Cloud-Edge-Even, Cloud-Edge-Opt).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

INF = float("inf")


@dataclass(frozen=True)
class PartitionProblem:
    """Arrays in paper notation. N units (embed + blocks + head), M devices.

    ``t_comp[i, j]``  per-token time of unit i on device j
    ``act_bytes[i]``  activation bytes unit i sends to unit i+1 (per step)
    ``bandwidth[k,j]`` bytes/s between devices (diagonal = inf)
    ``req[i]``        memory bytes to host unit i
    ``mem[j]``        memory budget of device j
    """

    t_comp: np.ndarray
    act_bytes: np.ndarray
    bandwidth: np.ndarray
    req: np.ndarray
    mem: np.ndarray
    source: int = 0

    def __post_init__(self):
        n, m = self.t_comp.shape
        assert self.act_bytes.shape == (n,)
        assert self.bandwidth.shape == (m, m)
        assert self.req.shape == (n,)
        assert self.mem.shape == (m,)

    @property
    def n(self) -> int:
        return self.t_comp.shape[0]

    @property
    def m(self) -> int:
        return self.t_comp.shape[1]

    def t_comm(self, i: int, k: int, j: int) -> float:
        """Eq. (1): activations of unit i from device k to device j."""
        if k == j:
            return 0.0
        return float(self.act_bytes[i] / self.bandwidth[k, j])


@dataclass(frozen=True)
class Stage:
    start: int   # first unit (inclusive)
    end: int     # last unit (inclusive)
    device: int


@dataclass
class Plan:
    """A full deployment plan: device of every unit + objective value."""

    assignment: np.ndarray          # [N] device index per unit
    objective: float                # latency s/token or max-stage-time s
    kind: str                       # "latency" | "throughput"

    @property
    def devices_used(self) -> List[int]:
        seen: List[int] = []
        for j in self.assignment:
            if j not in seen:
                seen.append(int(j))
        return seen

    @property
    def stages(self) -> List[Stage]:
        out: List[Stage] = []
        start = 0
        for i in range(1, len(self.assignment) + 1):
            if i == len(self.assignment) or self.assignment[i] != self.assignment[start]:
                out.append(Stage(start, i - 1, int(self.assignment[start])))
                start = i
        return out


INFEASIBLE = Plan(np.array([], dtype=int), INF, "infeasible")


def check_memory(prob: PartitionProblem, assignment: Sequence[int]) -> bool:
    used = np.zeros(prob.m)
    for i, j in enumerate(assignment):
        used[j] += prob.req[i]
    return bool(np.all(used <= prob.mem + 1e-9))


def plan_latency(prob: PartitionProblem, assignment: Sequence[int]) -> float:
    """Eq. (2) + the return hop of Eq. (6): T_tol of a given assignment."""
    t = prob.t_comp[0, assignment[0]]
    for i in range(1, prob.n):
        k, j = assignment[i - 1], assignment[i]
        t += prob.t_comm(i - 1, k, j) + prob.t_comp[i, j]
    t += prob.t_comm(prob.n - 1, assignment[-1], prob.source)
    return float(t)


def plan_stage_time(prob: PartitionProblem, assignment: Sequence[int]) -> float:
    """Eq. (9)/(10): the pipeline bottleneck stage time of an assignment."""
    worst = 0.0
    stages = Plan(np.asarray(assignment), 0.0, "throughput").stages
    for s_idx, st in enumerate(stages):
        comp = float(prob.t_comp[st.start:st.end + 1, st.device].sum())
        comm = 0.0
        if s_idx > 0:
            prev = stages[s_idx - 1]
            comm = prob.t_comm(prev.end, prev.device, st.device)
        worst = max(worst, comp, comm)
    return worst


# --------------------------------------------------------------------------- #
# Algo. 1 — latency DP
# --------------------------------------------------------------------------- #

def solve_latency(prob: PartitionProblem) -> Plan:
    """Paper Algo. 1: DP(i, j) = min time of first i units with unit i on j.

    The paper's pseudo-code updates device memory greedily while filling the
    table; we track a *per-state* remaining-memory vector (the natural reading
    of line 13), which is strictly more accurate than one global update and
    exact whenever the optimal path never needs to revisit a memory-tight
    device (true for all paper scenarios; the brute-force cross-check in the
    test-suite validates this).
    """
    n, m, src = prob.n, prob.m, prob.source
    dp = np.full((n, m), INF)
    choice = np.full((n, m), -1, dtype=int)
    mem_left = np.empty((n, m), dtype=object)

    if prob.req[0] > prob.mem[src]:
        return INFEASIBLE
    dp[0, src] = prob.t_comp[0, src]
    first_mem = prob.mem.astype(float).copy()
    first_mem[src] -= prob.req[0]
    mem_left[0, src] = first_mem

    for i in range(1, n):
        for j in range(m):
            best, best_k = INF, -1
            for k in range(m):
                if dp[i - 1, k] == INF:
                    continue
                if mem_left[i - 1, k][j] < prob.req[i]:
                    continue
                t = dp[i - 1, k] + prob.t_comp[i, j] + prob.t_comm(i - 1, k, j)
                if i == n - 1:
                    t += prob.t_comm(i, j, src)   # token returns to the source
                if t < best:
                    best, best_k = t, k
            if best_k >= 0:
                dp[i, j] = best
                choice[i, j] = best_k
                mv = mem_left[i - 1, best_k].copy()
                mv[j] -= prob.req[i]
                mem_left[i, j] = mv

    last = int(np.argmin(dp[n - 1]))
    if dp[n - 1, last] == INF:
        return INFEASIBLE
    assignment = np.empty(n, dtype=int)
    assignment[n - 1] = last
    for i in range(n - 1, 0, -1):
        assignment[i - 1] = choice[i, assignment[i]]
    return Plan(assignment, float(dp[n - 1, last]), "latency")


def solve_latency_contiguous(prob: PartitionProblem,
                             max_exact_devices: int = 10) -> Plan:
    """Exact latency DP over *contiguous* plans (each device hosts one
    contiguous slab, used at most once) — memory feasibility is exact, unlike
    the greedy accounting of the paper's Algo. 1.  Beyond-paper addition:
    :func:`solve_latency_best` returns the better of the two."""
    n, m, src = prob.n, prob.m, prob.source
    cum = _prefix_costs(prob)
    req_cum = np.concatenate([[0.0], np.cumsum(prob.req)])

    def seg_time(a, b, j):
        return _seg_comp(cum, a, b, j)

    def ret_hop(j):
        return prob.t_comm(n - 1, j, src)

    if m <= max_exact_devices:
        states: Dict[Tuple[int, int, int], float] = {}
        parent: Dict[Tuple, Optional[Tuple]] = {}
        for e in range(n):
            if _seg_req(req_cum, 0, e) > prob.mem[src]:
                break
            st = (e, 1 << src, src)
            states[st] = seg_time(0, e, src) + (ret_hop(src) if e == n - 1
                                                else 0.0)
            parent[st] = None
        frontier = dict(states)
        while frontier:
            nxt: Dict[Tuple[int, int, int], float] = {}
            for (e, mask, k), t in frontier.items():
                if e == n - 1:
                    continue
                for j in range(m):
                    if mask & (1 << j):
                        continue
                    comm = prob.t_comm(e, k, j)
                    for e2 in range(e + 1, n):
                        if _seg_req(req_cum, e + 1, e2) > prob.mem[j]:
                            break
                        tt = t + comm + seg_time(e + 1, e2, j)
                        if e2 == n - 1:
                            tt += ret_hop(j)
                        st = (e2, mask | (1 << j), j)
                        if tt < states.get(st, INF):
                            states[st] = tt
                            parent[st] = (e, mask, k)
                            nxt[st] = tt
            frontier = nxt
        return _extract_throughput_plan_generic(prob, states, parent,
                                                kind="latency")
    groups = _device_groups(prob)
    if groups is not None:
        return _latency_collapsed(prob, groups)
    # large fully-heterogeneous clusters: beam with a sum objective
    return _latency_beam(prob, beam_width=128)


def _latency_collapsed(prob: PartitionProblem,
                       groups: List[List[int]]) -> Plan:
    """Exact contiguous latency DP over interchangeable device groups."""
    n, src = prob.n, prob.source
    cum = _prefix_costs(prob)
    req_cum = np.concatenate([[0.0], np.cumsum(prob.req)])
    rep = [g[0] for g in groups]
    cap = [len(g) for g in groups]
    src_group = next(gi for gi, g in enumerate(groups) if src in g)
    counts0 = tuple(1 if gi == src_group else 0 for gi in range(len(groups)))

    g_tab: Dict[Tuple[int, Tuple[int, ...], int], float] = {}
    parent: Dict[Tuple, Optional[Tuple]] = {}
    for e in range(n):
        if _seg_req(req_cum, 0, e) > prob.mem[src]:
            break
        t = _seg_comp(cum, 0, e, src)
        if e == n - 1:
            t += prob.t_comm(n - 1, src, src)
        st = (e, counts0, src_group)
        g_tab[st] = t
        parent[st] = None
    frontier = dict(g_tab)
    while frontier:
        nxt = {}
        for (e, counts, kg), t in frontier.items():
            if e == n - 1:
                continue
            for jg in range(len(groups)):
                if counts[jg] >= cap[jg]:
                    continue
                j = rep[jg]
                comm = prob.t_comm(e, rep[kg], j)
                new_counts = tuple(c + (1 if gi == jg else 0)
                                   for gi, c in enumerate(counts))
                for e2 in range(e + 1, n):
                    if _seg_req(req_cum, e + 1, e2) > prob.mem[j]:
                        break
                    tt = t + comm + _seg_comp(cum, e + 1, e2, j)
                    if e2 == n - 1:
                        tt += prob.t_comm(n - 1, j, src)
                    st = (e2, new_counts, jg)
                    if tt < g_tab.get(st, INF):
                        g_tab[st] = tt
                        parent[st] = (e, counts, kg)
                        nxt[st] = tt
        frontier = nxt
    finals = [(t, st) for st, t in g_tab.items() if st[0] == n - 1]
    if not finals:
        return INFEASIBLE
    best_t, best_st = min(finals, key=lambda x: x[0])
    stages_rev = []
    st = best_st
    while st is not None:
        prev = parent[st]
        start = (prev[0] + 1) if prev is not None else 0
        stages_rev.append((start, st[0], st[2]))
        st = prev
    stages = list(reversed(stages_rev))
    assignment = np.empty(n, dtype=int)
    taken: Dict[int, List[int]] = {gi: [] for gi in range(len(groups))}
    for idx, (a, b, gi) in enumerate(stages):
        if idx == 0:
            dev = src
        else:
            dev = next(d for d in groups[gi]
                       if d != src and d not in taken[gi])
        taken[gi].append(dev)
        assignment[a:b + 1] = dev
    return Plan(assignment, float(best_t), "latency")


def _extract_throughput_plan_generic(prob, g, parent, kind: str) -> Plan:
    n = prob.n
    finals = [(t, st) for st, t in g.items() if st[0] == n - 1]
    if not finals:
        return INFEASIBLE
    best_t, best_st = min(finals, key=lambda x: x[0])
    stages: List[Stage] = []
    st = best_st
    while st is not None:
        prev = parent[st]
        start = (prev[0] + 1) if prev is not None else 0
        stages.append(Stage(start, st[0], st[2]))
        st = prev
    stages.reverse()
    assignment = np.empty(n, dtype=int)
    for s in stages:
        assignment[s.start:s.end + 1] = s.device
    return Plan(assignment, float(best_t), kind)


def _latency_beam(prob: PartitionProblem, beam_width: int) -> Plan:
    n, m, src = prob.n, prob.m, prob.source
    cum = _prefix_costs(prob)
    req_cum = np.concatenate([[0.0], np.cumsum(prob.req)])
    beam = []
    for e in range(n):
        if _seg_req(req_cum, 0, e) > prob.mem[src]:
            break
        t = _seg_comp(cum, 0, e, src)
        if e == n - 1:
            t += prob.t_comm(n - 1, src, src)
        beam.append((t, e, frozenset([src]), src,
                     (Stage(0, e, src),)))
    done = [b for b in beam if b[1] == n - 1]
    while beam:
        cand = []
        for t, e, used, k, stages in beam:
            if e == n - 1:
                continue
            for j in range(m):
                if j in used:
                    continue
                comm = prob.t_comm(e, k, j)
                for e2 in range(e + 1, n):
                    if _seg_req(req_cum, e + 1, e2) > prob.mem[j]:
                        break
                    tt = t + comm + _seg_comp(cum, e + 1, e2, j)
                    if e2 == n - 1:
                        tt += prob.t_comm(n - 1, j, src)
                    cand.append((tt, e2, used | {j}, j,
                                 stages + (Stage(e + 1, e2, j),)))
        cand.sort(key=lambda x: x[0])
        beam = cand[:beam_width]
        done.extend(b for b in beam if b[1] == n - 1)
    if not done:
        return INFEASIBLE
    best = min(done, key=lambda x: x[0])
    assignment = np.empty(n, dtype=int)
    for s in best[4]:
        assignment[s.start:s.end + 1] = s.device
    return Plan(assignment, float(best[0]), "latency")


def solve_latency_best(prob: PartitionProblem) -> Plan:
    """Best of the paper-faithful Algo. 1 and the exact contiguous DP."""
    a = solve_latency(prob)
    b = solve_latency_contiguous(prob)
    if a.objective <= b.objective:
        return a
    return b


def brute_force_latency(prob: PartitionProblem, max_states: int = 2_000_000) -> Plan:
    """Exact reference: enumerate every memory-feasible assignment."""
    n, m = prob.n, prob.m
    assert m ** (n - 1) <= max_states, "instance too large for brute force"
    best, best_a = INF, None
    for rest in itertools.product(range(m), repeat=n - 1):
        a = (prob.source,) + rest
        if not check_memory(prob, a):
            continue
        t = plan_latency(prob, a)
        if t < best:
            best, best_a = t, a
    if best_a is None:
        return INFEASIBLE
    return Plan(np.array(best_a), best, "latency")


# --------------------------------------------------------------------------- #
# Algo. 2 — throughput DP (contiguous stages, each device used at most once)
# --------------------------------------------------------------------------- #

def _prefix_costs(prob: PartitionProblem) -> np.ndarray:
    """cum[i, j] = sum of t_comp[0..i-1, j] for O(1) segment sums."""
    return np.vstack([np.zeros(prob.m), np.cumsum(prob.t_comp, axis=0)])


def _seg_comp(cum: np.ndarray, a: int, b: int, j: int) -> float:
    """t_comp^{a->b, j} (inclusive)."""
    return float(cum[b + 1, j] - cum[a, j])


def _seg_req(req_cum: np.ndarray, a: int, b: int) -> float:
    return float(req_cum[b + 1] - req_cum[a])


def solve_throughput(prob: PartitionProblem,
                     max_exact_devices: int = 10,
                     beam_width: int = 64) -> Plan:
    """Paper Algo. 2 with three engines, picked by instance structure:

    - exact bitmask DP (M <= ``max_exact_devices``),
    - symmetric-collapse DP when devices form interchangeable groups
      (the paper's 12xAGX + 2xNX + 1xRTX testbed),
    - beam search fallback for large fully-heterogeneous clusters.
    """
    if prob.m <= max_exact_devices:
        return _throughput_bitmask(prob)
    groups = _device_groups(prob)
    if groups is not None:
        return _throughput_collapsed(prob, groups)
    return _throughput_beam(prob, beam_width)


def _throughput_bitmask(prob: PartitionProblem) -> Plan:
    n, m, src = prob.n, prob.m, prob.source
    cum = _prefix_costs(prob)
    req_cum = np.concatenate([[0.0], np.cumsum(prob.req)])
    # state: (last_unit, used_mask, last_device) -> bottleneck time
    g: Dict[Tuple[int, int, int], float] = {}
    parent: Dict[Tuple[int, int, int], Optional[Tuple]] = {}
    for e in range(n):                 # first stage [0..e] on the source
        if _seg_req(req_cum, 0, e) > prob.mem[src]:
            break
        st = (e, 1 << src, src)
        g[st] = _seg_comp(cum, 0, e, src)
        parent[st] = None
    frontier = dict(g)
    while frontier:
        nxt: Dict[Tuple[int, int, int], float] = {}
        for (e, mask, k), t in frontier.items():
            if e == n - 1:
                continue
            for j in range(m):
                if mask & (1 << j):
                    continue
                comm = prob.t_comm(e, k, j)
                for e2 in range(e + 1, n):
                    if _seg_req(req_cum, e + 1, e2) > prob.mem[j]:
                        break
                    tt = max(t, comm, _seg_comp(cum, e + 1, e2, j))
                    st = (e2, mask | (1 << j), j)
                    if tt < g.get(st, INF):
                        g[st] = tt
                        parent[st] = (e, mask, k)
                        nxt[st] = tt
        frontier = nxt
    return _extract_throughput_plan(prob, g, parent)


def _extract_throughput_plan(prob, g, parent) -> Plan:
    n = prob.n
    finals = [(t, st) for st, t in g.items() if st[0] == n - 1]
    if not finals:
        return INFEASIBLE
    best_t, best_st = min(finals, key=lambda x: x[0])
    # reconstruct stage list
    stages: List[Stage] = []
    st = best_st
    while st is not None:
        prev = parent[st]
        start = (prev[0] + 1) if prev is not None else 0
        stages.append(Stage(start, st[0], st[2]))
        st = prev
    stages.reverse()
    assignment = np.empty(n, dtype=int)
    for s in stages:
        assignment[s.start:s.end + 1] = s.device
    return Plan(assignment, float(best_t), "throughput")


def _device_groups(prob: PartitionProblem) -> Optional[List[List[int]]]:
    """Group interchangeable devices: equal t_comp column, mem, and a
    bandwidth matrix that depends only on (group(k), group(j))."""
    m = prob.m
    keys = {}
    for j in range(m):
        key = (round(float(prob.mem[j]), 6),
               tuple(np.round(prob.t_comp[:, j], 12)))
        if j == prob.source:
            key = ("SRC",) + key       # the source is always its own group
        keys.setdefault(key, []).append(j)
    groups = list(keys.values())
    gid = {}
    for gi, members in enumerate(groups):
        for j in members:
            gid[j] = gi
    # verify bandwidth is group-consistent
    for a in range(m):
        for b in range(m):
            if a == b:
                continue
            ref = prob.bandwidth[a, b]
            for a2 in range(m):
                for b2 in range(m):
                    if a2 == b2 or gid[a2] != gid[a] or gid[b2] != gid[b]:
                        continue
                    if not np.isclose(prob.bandwidth[a2, b2], ref, rtol=1e-9):
                        return None
    if len(groups) >= m:               # no collapsing possible
        return None
    return groups


def _throughput_collapsed(prob: PartitionProblem, groups: List[List[int]]) -> Plan:
    """Exact DP over (last_unit, per-group used counts, last_group)."""
    n = prob.n
    cum = _prefix_costs(prob)
    req_cum = np.concatenate([[0.0], np.cumsum(prob.req)])
    rep = [g[0] for g in groups]                      # representative device
    cap = [len(g) for g in groups]
    src_group = next(gi for gi, g in enumerate(groups) if prob.source in g)

    g_tab: Dict[Tuple[int, Tuple[int, ...], int], float] = {}
    parent: Dict[Tuple, Optional[Tuple]] = {}
    counts0 = tuple(1 if gi == src_group else 0 for gi in range(len(groups)))
    for e in range(n):
        if _seg_req(req_cum, 0, e) > prob.mem[prob.source]:
            break
        st = (e, counts0, src_group)
        g_tab[st] = _seg_comp(cum, 0, e, prob.source)
        parent[st] = None
    frontier = dict(g_tab)
    while frontier:
        nxt = {}
        for (e, counts, kg), t in frontier.items():
            if e == n - 1:
                continue
            for jg in range(len(groups)):
                if counts[jg] >= cap[jg]:
                    continue
                j = rep[jg]
                comm = prob.t_comm(e, rep[kg], j)
                new_counts = tuple(c + (1 if gi == jg else 0)
                                   for gi, c in enumerate(counts))
                for e2 in range(e + 1, n):
                    if _seg_req(req_cum, e + 1, e2) > prob.mem[j]:
                        break
                    tt = max(t, comm, _seg_comp(cum, e + 1, e2, j))
                    st = (e2, new_counts, jg)
                    if tt < g_tab.get(st, INF):
                        g_tab[st] = tt
                        parent[st] = (e, counts, kg)
                        nxt[st] = tt
        frontier = nxt
    finals = [(t, st) for st, t in g_tab.items() if st[0] == n - 1]
    if not finals:
        return INFEASIBLE
    best_t, best_st = min(finals, key=lambda x: x[0])
    # reconstruct, materializing concrete device ids per group on the fly
    stages_rev: List[Tuple[int, int, int]] = []
    st = best_st
    while st is not None:
        prev = parent[st]
        start = (prev[0] + 1) if prev is not None else 0
        stages_rev.append((start, st[0], st[2]))
        st = prev
    next_free = {gi: iter(members) for gi, members in enumerate(groups)}
    # source group: source device must be used for the first stage
    assignment = np.empty(n, dtype=int)
    stages = list(reversed(stages_rev))
    taken: Dict[int, List[int]] = {gi: [] for gi in range(len(groups))}
    for idx, (a, b, gi) in enumerate(stages):
        if idx == 0:
            dev = prob.source
        else:
            dev = next(d for d in groups[gi]
                       if d != prob.source and d not in taken[gi])
        taken[gi].append(dev)
        assignment[a:b + 1] = dev
    return Plan(assignment, float(best_t), "throughput")


def _throughput_beam(prob: PartitionProblem, beam_width: int) -> Plan:
    """Beam-search fallback for large heterogeneous clusters (beyond-paper)."""
    n, m = prob.n, prob.m
    cum = _prefix_costs(prob)
    req_cum = np.concatenate([[0.0], np.cumsum(prob.req)])
    Beam = List[Tuple[float, int, frozenset, int, Tuple[Stage, ...]]]
    beam: Beam = []
    for e in range(n):
        if _seg_req(req_cum, 0, e) > prob.mem[prob.source]:
            break
        beam.append((_seg_comp(cum, 0, e, prob.source), e,
                     frozenset([prob.source]), prob.source,
                     (Stage(0, e, prob.source),)))
    done: Beam = [b for b in beam if b[1] == n - 1]
    while beam:
        cand: Beam = []
        for t, e, used, k, stages in beam:
            if e == n - 1:
                continue
            for j in range(m):
                if j in used:
                    continue
                comm = prob.t_comm(e, k, j)
                for e2 in range(e + 1, n):
                    if _seg_req(req_cum, e + 1, e2) > prob.mem[j]:
                        break
                    tt = max(t, comm, _seg_comp(cum, e + 1, e2, j))
                    cand.append((tt, e2, used | {j}, j,
                                 stages + (Stage(e + 1, e2, j),)))
        cand.sort(key=lambda x: x[0])
        beam = cand[:beam_width]
        done.extend(b for b in beam if b[1] == n - 1)
    if not done:
        return INFEASIBLE
    best = min(done, key=lambda x: x[0])
    assignment = np.empty(n, dtype=int)
    for s in best[4]:
        assignment[s.start:s.end + 1] = s.device
    return Plan(assignment, float(best[0]), "throughput")


def brute_force_throughput(prob: PartitionProblem) -> Plan:
    """Exact reference: enumerate contiguous-stage partitions over device
    permutations (tiny instances only)."""
    n, m = prob.n, prob.m
    best, best_a = INF, None
    devices = list(range(m))
    others = [d for d in devices if d != prob.source]
    for n_stages in range(1, min(n, m) + 1):
        for cuts in itertools.combinations(range(1, n), n_stages - 1):
            bounds = [0, *cuts, n]
            for perm in itertools.permutations(others, n_stages - 1):
                order = [prob.source, *perm]
                a = np.empty(n, dtype=int)
                for s in range(n_stages):
                    a[bounds[s]:bounds[s + 1]] = order[s]
                if not check_memory(prob, a):
                    continue
                t = plan_stage_time(prob, a)
                if t < best:
                    best, best_a = t, a.copy()
    if best_a is None:
        return INFEASIBLE
    return Plan(best_a, best, "throughput")


# --------------------------------------------------------------------------- #
# Baselines (paper §V-A)
# --------------------------------------------------------------------------- #

def even_partition(prob: PartitionProblem, devices: Sequence[int]) -> Plan:
    """Split units evenly (by count) across ``devices`` in order."""
    n = prob.n
    k = len(devices)
    per = n // k
    extra = n % k
    assignment = np.empty(n, dtype=int)
    pos = 0
    for s, dev in enumerate(devices):
        size = per + (1 if s < extra else 0)
        assignment[pos:pos + size] = dev
        pos += size
    if not check_memory(prob, assignment):
        return INFEASIBLE
    return Plan(assignment, plan_stage_time(prob, assignment), "throughput")


def edge_solo(prob: PartitionProblem) -> Plan:
    """Everything on the source device (Edge-Solo baseline)."""
    a = np.full(prob.n, prob.source, dtype=int)
    if not check_memory(prob, a):
        return INFEASIBLE
    return Plan(a, plan_latency(prob, a), "latency")


def restrict(prob: PartitionProblem, devices: Sequence[int]) -> Tuple[PartitionProblem, List[int]]:
    """Sub-problem over a device subset (source must be included first)."""
    devices = list(devices)
    assert devices[0] == prob.source
    idx = np.asarray(devices)
    return PartitionProblem(
        prob.t_comp[:, idx], prob.act_bytes,
        prob.bandwidth[np.ix_(idx, idx)], prob.req, prob.mem[idx], 0), devices


def lift_plan(plan: Plan, devices: List[int]) -> Plan:
    if plan.objective == INF:
        return plan
    return Plan(np.asarray([devices[j] for j in plan.assignment]),
                plan.objective, plan.kind)


def cloud_edge_plans(prob: PartitionProblem, cloud: int) -> Dict[str, Plan]:
    """Cloud-Edge-Even and Cloud-Edge-Opt (2-device special cases)."""
    sub, devs = restrict(prob, [prob.source, cloud])
    even = even_partition(sub, [0, 1])
    if even.objective != INF:
        even = Plan(even.assignment, plan_latency(sub, even.assignment), "latency")
    opt = solve_latency(sub)
    opt_thru = solve_throughput(sub)
    return {
        "cloud-edge-even": lift_plan(even, devs),
        "cloud-edge-opt": lift_plan(opt, devs),
        "cloud-edge-opt-throughput": lift_plan(opt_thru, devs),
    }
