"""The port's re-issuable work queue against repro's: the same take,
complete and fail sequences on both, with every return value and the
queue's state (pending, in flight, done, finished) equal after each call.
The sequences include those of ``tests/distributed/test_fault_tolerance.py``
(every other chunk's worker dies once) and ``tests/core/test_resume.py``
(the first chunk fails after the second is taken).
"""

import pytest

from repro.distributed import fault_tolerance as jft
from repro_torch.distributed import fault_tolerance as ft


def _alternate_fail_complete(q, log):
    """Take until finished; the worker of every other take dies."""
    fail_next = True
    while not q.finished:
        item = q.take()
        log(item)
        if item is None:
            break
        t, _ = item
        log(q.fail(t) if fail_next else q.complete(t))
        fail_next = not fail_next


def _reissue(q, log):
    """Two takes, the first worker dies, the second completes, then drain."""
    t1, _ = q.take()
    t2, _ = q.take()
    log(q.fail(t1))
    log(q.complete(t2))
    while (item := q.take()) is not None:
        log(item)
        log(q.complete(item[0]))
    log(q.take())


def _fail_all_then_drain(q, log):
    """Three chunks in flight, all fail (last taken first), then drain in
    reverse completion order."""
    held = [q.take() for _ in range(3)]
    log(held)
    for t, _ in reversed(held):
        log(q.fail(t))
    taken = []
    while (item := q.take()) is not None:
        taken.append(item)
        log(item)
    for t, _ in reversed(taken):
        log(q.complete(t))


def _drain(q, log):
    """Nothing fails."""
    while (item := q.take()) is not None:
        log(item)
        log(q.complete(item[0]))
    log(q.take())


@pytest.mark.parametrize("total,chunk,driver", [
    (1000, 128, _alternate_fail_complete),   # test_fault_tolerance.py
    (100, 30, _reissue),                      # test_resume.py
    (256, 64, _fail_all_then_drain),
    (7, 3, _alternate_fail_complete),
    (64, 64, _drain),
    (0, 16, _drain),
])
def test_work_queue_matches_reference(total, chunk, driver):
    def run(module):
        q = module.WorkQueue(total_samples=total, chunk=chunk)
        seen = [(list(q.pending), q.finished)]

        def log(value):
            seen.append((value, list(q.pending), dict(q.in_flight), list(q.done),
                         q.finished))

        driver(q, log)
        return seen, q

    want, jq = run(jft)
    got, q = run(ft)
    assert got == want
    assert q.finished and jq.finished
    assert sorted(q.done) == sorted(jq.done)
    assert sum(n for _, n in q.done) == total
