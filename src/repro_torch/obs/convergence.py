"""Per-stream convergence accounting: stderr-vs-rounds trajectories.

The cache knows each stream's *current* stderr; nothing in the service
remembered how it got there.  This module records one
:class:`TrajectoryPoint` per folded round at deposit time — the
measured-variance data an adaptive planner can allocate samples by,
and the raw material for the paper's convergence plots.

Recording happens inside :meth:`ResultCache.deposit_wave` right after
each round folds, so a trajectory is exactly the sequence of states the
engine's precision checks saw: ``(rounds_done, n, stderr_max,
stderr_mean)`` after every fold.  Deposits are wave-batched host work
(off the device critical path) and each point is O(n_fn) numpy — the
same cost as one ``meets()`` check the engine already pays per wave.

Memory is bounded per stream: past ``max_points`` the log *decimates* —
it keeps every other retained point and doubles its sampling stride, so
a million-round stream keeps a uniformly-thinned skeleton of its whole
history instead of an arbitrary prefix or suffix.  The stream's latest
point is always reported (tracked separately as the frontier), so a
trajectory ends at the true fold frontier regardless of stride.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class TrajectoryPoint:
    """Stream state right after one round folded."""

    rounds_done: int     # fold frontier after this round
    n: int               # accumulated samples
    stderr_max: float    # worst per-function standard error
    stderr_mean: float   # mean per-function standard error


@dataclasses.dataclass
class _Traj:
    points: list            # retained points, one per `stride` records
    stride: int = 1
    pending: int = 0        # records since the last retained point
    frontier: TrajectoryPoint | None = None   # latest, if not retained


class ConvergenceLog:
    """Bounded per-stream trajectories, keyed by stream content hash."""

    def __init__(self, max_points: int = 512):
        if max_points < 4:
            raise ValueError("max_points must be at least 4")
        self.max_points = int(max_points)
        self._lock = threading.Lock()
        self._streams: dict[str, _Traj] = {}

    def record(self, chash: str, *, rounds_done: int, n: int,
               stderr_max: float, stderr_mean: float) -> None:
        point = TrajectoryPoint(rounds_done=int(rounds_done), n=int(n),
                                stderr_max=float(stderr_max),
                                stderr_mean=float(stderr_mean))
        with self._lock:
            traj = self._streams.get(chash)
            if traj is None:
                traj = self._streams[chash] = _Traj(points=[])
            traj.pending += 1
            if traj.pending >= traj.stride:
                traj.points.append(point)
                traj.pending = 0
                traj.frontier = None
                if len(traj.points) > self.max_points:
                    traj.points = traj.points[::2]
                    traj.stride *= 2
            else:
                traj.frontier = point

    def trajectory(self, chash: str) -> list[TrajectoryPoint]:
        """Thinned history plus the exact current frontier point."""
        with self._lock:
            traj = self._streams.get(chash)
            if traj is None:
                return []
            points = list(traj.points)
            if traj.frontier is not None:
                points.append(traj.frontier)
            return points

    def stride(self, chash: str) -> int:
        with self._lock:
            traj = self._streams.get(chash)
            return traj.stride if traj is not None else 1

    def streams(self) -> list[str]:
        with self._lock:
            return list(self._streams)

    def snapshot(self) -> dict:
        """JSON-able ``{chash: {"stride", "points": [[rounds, n,
        stderr_max, stderr_mean], ...]}}`` for bench/CLI artifacts."""
        out = {}
        for chash in self.streams():
            points = self.trajectory(chash)
            out[chash] = {
                "stride": self.stride(chash),
                "points": [[p.rounds_done, p.n, p.stderr_max, p.stderr_mean]
                           for p in points],
            }
        return out
