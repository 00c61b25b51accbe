"""The worker partitioner's list schedule (``core/schedule.py``
``_list_schedule``) against the loop it replaces.

The list schedule prices a task's earliest start on every worker from
the workers' free times and its producers' finish times (a producer on
another worker adds the task's cross-worker wait).  The port computes
the same maxima in O(W + producers) a task instead of looping over every
(worker, producer) pair; the queues must be the same, worker for worker
and task for task, so that every plan stays the reference's.  Here the
loop (``_loop_schedule``, the former code) and the port's function run
on the compiled tGraphs of every family at reduced size over a range of
widths, and on deepseek-7b at full width (2 layers) at W = 132."""
import dataclasses
import heapq

import pytest

from repro_torch.configs import get_config
from repro_torch.core.schedule import (_list_schedule, _preds_map,
                                       critical_path_depths,
                                       default_cross_wait,
                                       default_task_time)
from repro_torch.megakernel import compile_decode_megakernel


def _loop_schedule(tg, lin, width, depth, deps, preds):
    """The list schedule as a loop over every worker and every producer:
    ready tasks in longest-critical-path order (ties by the linearized
    position), each on the first worker where it can start earliest."""
    succ = {tid: [] for tid in tg.tasks}
    indeg = {tid: 0 for tid in tg.tasks}
    for a, b in deps:
        succ[a].append(b)
        indeg[b] += 1
    ready = []
    for tid in tg.tasks:
        if indeg[tid] == 0:
            heapq.heappush(ready, (-depth.get(tid, 0.0), lin.index[tid],
                                   tid))
    queues = [[] for _ in range(width)]
    worker_free = [0.0] * width
    worker_of, done = {}, {}
    while ready:
        _d, _i, tid = heapq.heappop(ready)
        task = tg.tasks[tid]
        wait = default_cross_wait(task)
        best_w, best_start = 0, float("inf")
        for k in range(width):
            avail = worker_free[k]
            for p in preds.get(tid, ()):
                t_ready = done[p] + (0.0 if worker_of[p] == k else wait)
                if t_ready > avail:
                    avail = t_ready
            if avail < best_start:
                best_w, best_start = k, avail
        worker_of[tid] = best_w
        queues[best_w].append(tid)
        done[tid] = best_start + default_task_time(task, False)
        worker_free[best_w] = done[tid]
        for m in succ[tid]:
            indeg[m] -= 1
            if indeg[m] == 0:
                heapq.heappush(ready, (-depth.get(m, 0.0), lin.index[m], m))
    return queues


def _both(cfg, widths, max_seq=16):
    compiled = compile_decode_megakernel(cfg, 2, max_seq).compiled
    tg, lin = compiled.tg, compiled.lin
    deps = tg.task_dependencies()
    preds = _preds_map(deps)
    depth = critical_path_depths(tg)
    cost = {tid: (default_task_time(t, False), default_cross_wait(t))
            for tid, t in tg.tasks.items()}
    for width in widths:
        want = _loop_schedule(tg, lin, width, depth, deps, preds)
        got = _list_schedule(tg, lin, width, depth, deps, preds, cost)
        assert got == want, width


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "qwen2-vl-2b", "gemma-7b"])
def test_list_schedule_equals_the_loop_reduced(arch):
    """Every family at reduced size (2 layers), widths 2-8, 16 and 33."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    _both(cfg, list(range(2, 9)) + [16, 33])


def test_list_schedule_equals_the_loop_full_width():
    """deepseek-7b at full width, 2 layers, B = 2, S = 128, at W = 132
    (the card's SM count)."""
    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=2)
    _both(cfg, [132], max_seq=128)
