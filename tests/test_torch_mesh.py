"""The port's cell sharding (``parallel/mesh.py``) and its locked counters
(``utils/counters.py``), on the CPU.

``CellSharding.split`` cuts a bucket's rows into one contiguous range a
device, each a multiple of ``batch_multiple``, as even as that allows, in
shard order, with empty ranges left out; ``map`` runs one thread a range
and returns the results in shard order, and a shard's exception reaches the
caller after the other shards have finished. ``make_mesh`` raises where the
CUDA devices asked for do not exist. The launch counters lose no update when
many threads bump them at once.
"""

import collections
import sys
import threading
import time

import pytest
import torch

from optimalinterpolation_tpu_torch.parallel.mesh import (
    CellSharding,
    cell_sharding,
    day_cell_mesh,
    make_mesh,
)
from optimalinterpolation_tpu_torch.utils import counters


def _ranges(n_shards, n_rows, bm):
    return [(s, (r.start, r.stop)) for s, r in
            cell_sharding(make_mesh(devices=["cpu"] * n_shards)).split(n_rows, bm)]


@pytest.mark.parametrize("n_shards, n_rows, bm, want", [
    (3, 96, 8, [(0, (0, 32)), (1, (32, 64)), (2, (64, 96))]),
    (3, 104, 8, [(0, (0, 40)), (1, (40, 72)), (2, (72, 104))]),  # 13 units: 5, 4, 4
    (16, 40, 8, [(s, (8 * s, 8 * s + 8)) for s in range(5)]),  # 11 shards empty
    (2, 13, 8, [(0, (0, 8)), (1, (8, 13))]),  # the last range takes the remainder
    (4, 7, 1, [(0, (0, 2)), (1, (2, 4)), (2, (4, 6)), (3, (6, 7))]),
    (3, 0, 8, []),
])
def test_split_cuts_rows_in_batch_multiples(n_shards, n_rows, bm, want):
    got = _ranges(n_shards, n_rows, bm)
    assert got == want
    if got:  # contiguous, covering, multiples of bm but for the end
        assert got[0][1][0] == 0 and got[-1][1][1] == n_rows
        assert all(a[1][1] == b[1][0] for a, b in zip(got, got[1:]))
        assert all((e - s) % bm == 0 for _, (s, e) in got[:-1])


def test_map_runs_a_thread_a_shard_in_shard_order():
    sharding = cell_sharding(make_mesh(devices=["cpu"] * 16))
    seen = []

    def fn(rows, dev):
        seen.append(threading.current_thread().name)
        time.sleep(0.01 * (5 - rows.start // 8))  # later shards finish first
        return rows.start, rows.stop, dev

    out = sharding.map(40, fn, batch_multiple=8)
    assert [(s, e) for s, e, _ in out] == [(8 * i, 8 * i + 8) for i in range(5)]
    assert all(d == torch.device("cpu") for _, _, d in out)
    assert len(seen) == 5 and threading.current_thread().name not in seen
    assert sharding.map(0, fn, batch_multiple=8) == []


def test_a_shard_failure_reaches_the_caller_after_the_others_finish():
    sharding = cell_sharding(make_mesh(devices=["cpu"] * 4))
    finished = []

    def fn(rows, dev):
        if rows.start == 8:
            raise ValueError("shard 1 failed")
        time.sleep(0.05)
        finished.append(rows.start)
        return rows.start

    with pytest.raises(ValueError, match="shard 1 failed"):
        sharding.map(32, fn, batch_multiple=8)
    assert sorted(finished) == [0, 16, 24]


def test_make_mesh_raises_for_cards_that_are_not_there():
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(count + 1)
    if count == 0:
        for bad in (lambda: make_mesh(2), lambda: make_mesh(), lambda: make_mesh(
                devices=["cuda:0", "cuda:0"]), lambda: CellSharding(["cuda:0"])):
            with pytest.raises(RuntimeError, match="CUDA"):
                bad()
    with pytest.raises(RuntimeError, match="3 devices asked for, 2 given"):
        make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="unknown device kind"):
        make_mesh(2, kind="tpu")


def test_meshes_of_repeated_devices():
    assert make_mesh(3, kind="cpu") == (torch.device("cpu"),) * 3
    assert make_mesh(2, devices=["cpu"] * 4) == (torch.device("cpu"),) * 2
    assert day_cell_mesh((2, 4), devices=["cpu"] * 8) == (torch.device("cpu"),) * 8
    assert len(cell_sharding(day_cell_mesh((2, 2), devices=["cpu"] * 4))) == 4


def test_locked_counters_lose_no_update():
    """8 threads x 10,000 increments of each counter, switching threads
    every microsecond: no increment is lost."""

    def owner():
        pass

    owner.launches = 0
    owner.host_syncs = 0
    owner.streams = collections.Counter()
    owner.rows = collections.Counter()

    def work(i):
        for _ in range(10_000):
            counters.bump(owner, "host_syncs")
            counters.launched(owner, i % 2, rows=8)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert owner.host_syncs == 80_000 and owner.launches == 80_000
    assert owner.streams == {0: 40_000, 1: 40_000} and owner.rows == {8: 80_000}
