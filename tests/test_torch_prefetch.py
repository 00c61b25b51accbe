"""The megakernel's prefetch plan on the CPU: the property that would
make reading a prefetched tile after its own wait safe on the card, and
the plain version's counter blocks.

The reference issues a task's primary tile (words 28-30) a grid step
ahead, into a second buffer, before the task's event wait; that is safe
only while the workers run in step, and on the card CTAs drift many steps
apart.  The port's kernel reads words 24-27 and does not act on them:
every primary tile is demand-loaded after its task's wait.  A port of the
prefetch for the card would copy a tile with word 27 = 1 after its own
task's wait, and only the plan makes that safe.  The properties, over the
static plans of every family (dense, MoE, SSM and embedding-input, W ∈
{1, 2, 4}, and a TP=2 stamp):

* the row's grid predecessor on its lane carries the prefetch (words
  24-26 equal the row's 28-30) and writes nothing the tile holds: the
  task just before never produces a prefetched tile;
* every row that writes the tile precedes the row in the plan's order
  (its lane's order and the event edges): a copy at the row's start,
  after its wait, reads what they stored;
* a copy made earlier, during the grid predecessor (where the walk runs
  it just before the row), after that task's wait and the row's own
  event had triggered, would be safe too: every such writer precedes
  the predecessor's start or signals into the row's event;
* the plain version, as the kernel, counts no prefetched tile (word 2)
  and a demand load (word 3) for every primary tile, on each worker, the
  same over the compacted walk, the whole grid and a traced run; a
  dynamic plan has no prefetch plan.

Every interval is read off the descriptor words, as the kernel reads
them; the cache rows a kind-7 task writes are taken whole (their
position is data)."""
import dataclasses
from collections import defaultdict

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.megakernel import (MegakernelExecutor,
                                    compile_decode_megakernel,
                                    megakernel_plain)
from repro_torch.megakernel.kernel import check_plan
from repro_torch.megakernel.ops import read_stats_block

B, S = 2, 16
FAMILIES = {"dense": "deepseek-7b", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-2.7b", "embed": "qwen2-vl-2b"}
CASES = [(f, w, 1) for f in FAMILIES for w in (1, 2, 4)] + [("dense", 2, 2)]


def _cfg(family, layers=2):
    return dataclasses.replace(get_config(FAMILIES[family]).reduced(),
                               n_layers=layers)


def _width(valid, statics):
    chw = min(statics["STORE_CH"], statics["TN"])
    return min(statics["TN"], -(-valid // chw) * chw) if valid > 0 else 0


def _writes(d, statics):
    """The heap intervals [lo, hi) a row may write."""
    kind, m = int(d[0]), int(d[1])
    ws = _width(int(d[2]), statics)
    if kind == 0:
        return []
    if kind in (14, 15):
        return [(d[4] + r * d[5], d[4] + r * d[5] + d[3]) for r in range(m)]
    if kind == 7:                       # the whole cache of each row
        span = (statics["S_MAX"] - 1) * d[5] + ws
        return [(d[4] + r * d[15], d[4] + r * d[15] + span)
                for r in range(m)]
    out = [(d[4] + r * d[5], d[4] + r * d[5] + ws) for r in range(m)]
    if kind == 12:                      # the state tiles, in place
        nht, hds, ns = (statics[k] for k in ("NH_TILE", "HD_SSM", "N_SSM"))
        span = (nht - 1) * d[16] + (hds - 1) * d[9] + ns
        out += [(d[8] + r * d[15], d[8] + r * d[15] + span)
                for r in range(m)]
    if kind == 13:                      # the conv window, in place
        span = (statics["W_CONV"] - 1) * d[9] + ws
        out += [(d[8] + r * d[15], d[8] + r * d[15] + span)
                for r in range(m)]
    return out


def _cols(d, statics):
    """The columns of a row's primary tile its kind reads: the matmul's
    and expert GEMM's K, rope's heads a store column touches, the
    attention's query heads, the embedding's one row of ``m`` token ids,
    the SSM's head tile, else the store width."""
    kind, m = int(d[0]), int(d[1])
    ws = _width(int(d[2]), statics)
    if kind in (1, 10):
        return int(d[3])
    if kind in (2, 9):
        return int(d[2])
    if kind == 3:
        hd = statics["HD"]
        return min(statics["TN"] // hd, -(-ws // hd)) * hd
    if kind == 6:
        return int(d[16]) * statics["G"] * statics["HD"]
    if kind == 8:
        return m
    if kind == 12:
        return statics["NH_TILE"] * statics["HD_SSM"]
    return ws                           # 4, 5, 7, 13


def _reads(d, statics):
    """The heap intervals of a row's primary tile (all d[30] rows)."""
    cols = _cols(d, statics)
    return [(d[28] + r * d[29], d[28] + r * d[29] + cols)
            for r in range(int(d[30]))]


def _overlap(a, b):
    return any(lo < whi and wlo < hi for lo, hi in a for wlo, whi in b)


def _lanes(plan):
    """Each lane's real rows (the walk lists), in order."""
    W, walk = plan.num_workers, plan.walk
    return [walk[W + 1 + walk[w]:W + 1 + walk[w + 1]].tolist()
            for w in range(W)]


def _ancestors(plan, lanes):
    """Row -> the set of real rows that precede its start: its lane's
    earlier rows and, through the event edges (a signal of event e
    precedes every wait on e), theirs."""
    d = plan.descs
    preds = defaultdict(set)
    for lane in lanes:
        for a, b in zip(lane, lane[1:]):
            preds[b].add(a)
    signals = defaultdict(list)
    for lane in lanes:
        for r in lane:
            if d[r, 34] >= 0:
                signals[int(d[r, 34])].append(r)
    for lane in lanes:
        for r in lane:
            if d[r, 32] >= 0:
                preds[r].update(signals[int(d[r, 32])])
    memo = {}

    def anc(r):
        if r not in memo:
            seen, todo = set(), list(preds[r])
            while todo:
                p = todo.pop()
                if p not in seen:
                    seen.add(p)
                    todo.extend(preds[p] - seen)
            memo[r] = seen
        return memo[r]
    return anc, signals


_PLANS = {}


def _plan(family, workers, tp):
    key = (family, workers, tp)
    if key not in _PLANS:
        _PLANS[key] = compile_decode_megakernel(_cfg(family), B, S,
                                                num_workers=workers, tp=tp)
    return _PLANS[key]


@pytest.mark.parametrize("family,workers,tp", CASES)
def test_prefetched_tiles_are_safe_to_read_after_their_wait(family, workers,
                                                            tp):
    """The three plan properties of the module docstring, for every row
    with word 27 = 1; and the plan passes ``check_plan``."""
    plan = _plan(family, workers, tp)
    d, st, W = plan.descs, plan.statics, plan.num_workers
    check_plan(st, d)
    lanes = _lanes(plan)
    anc, signals = _ancestors(plan, lanes)
    prev = {b: a for lane in lanes for a, b in zip(lane, lane[1:])}
    writes = {r: _writes(d[r], st) for lane in lanes for r in lane}
    rows = np.flatnonzero((d[:, 27] == 1) & (d[:, 30] > 0) & (d[:, 0] != 0))
    assert rows.size > 0
    ahead = produced = 0
    for j in rows:
        j = int(j)
        reads = _reads(d[j], st)
        issuer = j - W
        assert issuer >= 0 and (d[issuer, 24:27] == d[j, 28:31]).all(), j
        assert not _overlap(_writes(d[issuer], st), reads), (j, issuer)
        # (none: a step input the host wrote, or a weight)
        writers = [p for p, w in writes.items()
                   if p != j and _overlap(w, reads)]
        produced += bool(writers)
        for p in writers:
            assert p in anc(j), (j, p)
        i = prev.get(j)
        if i is not None and i == issuer and d[i, 0] != 0:
            ahead += 1
            ev = signals[int(d[j, 32])] if d[j, 32] >= 0 else []
            covered = anc(i).union(*(anc(s) | {s} for s in ev))
            for p in writers:
                assert p != i and p in covered, (j, i, p)
    assert ahead > 0 and produced > 0


@pytest.mark.parametrize("family,workers,tp", CASES)
def test_plain_counts_every_primary_as_a_demand_load(family, workers, tp):
    """The plain version's counter blocks over the compacted walk, the
    whole grid and a traced run are one another's, and on each worker
    word 2 is 0 and word 3 counts every primary tile of its task rows,
    those with word 27 = 1 among them."""
    cfg = _cfg(family, 1)
    blocks = []
    for trace in (False, True):
        plan = compile_decode_megakernel(cfg, B, S, num_workers=workers,
                                         tp=tp, trace=trace)
        ex = MegakernelExecutor(plan, cfg, device="cpu")
        ex.init_weights(torch.Generator().manual_seed(3))
        rng = np.random.default_rng(1)
        inputs = (rng.standard_normal((B, cfg.d_model)).astype(np.float32)
                  if cfg.embed_input else rng.integers(1, cfg.vocab, B))
        ex.write_step_inputs(inputs, np.array([1, 4]))
        full = ex.heap.clone()
        ex.launch()
        blocks.append(ex.worker_counters())
        if not trace:
            megakernel_plain(full, plan.descs, plan.statics, acks=plan.acks)
            blocks.append(read_stats_block(full, plan.stats_offset,
                                           plan.num_workers))
    assert blocks[0] == blocks[1] == blocks[2]
    d, W = plan.descs, plan.num_workers
    prim = (d[:, 0] != 0) & (d[:, 30] > 0)
    lane = np.arange(d.shape[0]) % W
    for w, c in enumerate(blocks[0]):
        assert c["prefetch_tiles"] == 0
        assert c["primary_fallbacks"] == int((prim & (lane == w)).sum())
    assert (prim & (d[:, 27] == 1)).any()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_dynamic_plan_has_no_prefetch(family):
    """A dynamic plan carries no prefetch plan (words 24-27 zero), and its
    plain run counts every primary tile as a demand load."""
    cfg = _cfg(family, 1)
    plan = compile_decode_megakernel(cfg, B, S, num_workers=2,
                                     scheduler="dynamic")
    assert not plan.descs[:, 24:28].any()
    ex = MegakernelExecutor(plan, cfg, device="cpu")
    ex.init_weights(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(1)
    inputs = (rng.standard_normal((B, cfg.d_model)).astype(np.float32)
              if cfg.embed_input else rng.integers(1, cfg.vocab, B))
    ex.write_step_inputs(inputs, np.array([1, 4]))
    ex.launch()
    counters = ex.worker_counters()
    d = plan.descs
    assert sum(c["prefetch_tiles"] for c in counters) == 0
    assert sum(c["primary_fallbacks"] for c in counters) \
        == int(((d[:, 0] != 0) & (d[:, 30] > 0)).sum())
