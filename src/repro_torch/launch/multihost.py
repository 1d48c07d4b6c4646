"""Starting the ranks of a multi-device run (port of
``repro.launch.multihost``).

Every rank is one process running the same program (SPMD).  Two ways in:

* :func:`initialize_if_needed` joins a process group described by the
  environment: ``repro``'s ``REPRO_COORD`` (``host:port`` of rank 0),
  ``REPRO_NUM_PROCS`` and ``REPRO_PROC_ID``, or torchrun's ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
* :func:`spawn` starts ``n`` local ranks itself (the launchers' ``--mesh``
  without torchrun, the tests, ``chip_smoke.py``) and returns what each
  returned.

The backend is NCCL on the card and gloo on the CPU.  NCCL needs a card
per rank; ranks that share a card must ask for gloo by name (no silent
switch).  Build the kernels (``repro_torch.kernels.build.build()``)
before starting ranks on the card: a rank never builds them.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_lib
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# How long a collective may wait for the other ranks.
COLLECTIVE_TIMEOUT_S = 300.0


def choose_backend(device, n_local: int, backend: str | None = None) -> str:
    """The process-group backend for ``n_local`` ranks on this host
    computing on ``device``: NCCL for the card, gloo for the CPU, unless
    named.  Raises for NCCL on the CPU or with fewer cards than ranks."""
    kind = resolve_device(device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo'; got {backend!r}")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("NCCL runs on the card; use gloo for the CPU")
        if n_local > torch.cuda.device_count():
            raise ValueError(
                f"NCCL needs one card per rank: {n_local} ranks, "
                f"{torch.cuda.device_count()} card(s); ranks that share a "
                "card need backend='gloo'")
    return backend


def _init(backend: str, init_method: str, rank: int, world: int, kind: str) -> None:
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def initialize_if_needed(verbose: bool = True, *, device=None,
                         backend: str | None = None) -> bool:
    """Join the process group the environment describes.  Returns True if
    a group is set up (already, or now), False for a single-process run
    (no such environment)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if env.get("REPRO_COORD") and env.get("REPRO_NUM_PROCS") and env.get("REPRO_PROC_ID"):
        init_method = f"tcp://{env['REPRO_COORD']}"
        world, rank = int(env["REPRO_NUM_PROCS"]), int(env["REPRO_PROC_ID"])
    elif env.get("RANK") and env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        init_method = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    n_local = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = choose_backend(device, n_local, backend)
    _init(backend, init_method, rank, world, resolve_device(device).type)
    if verbose:
        print(f"[multihost] process {rank}/{world} ({backend})")
    return True


def _rank_main(fn, rank, world, backend, kind, init_method, results, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    if kind == "cpu":
        # the ranks share the host's cores: more intra-op threads than
        # cores make every collective wait on spinning threads (10x slower)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        _init(backend, init_method, rank, world, kind)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, n_ranks: int, *args, device="cpu", backend: str | None = None,
          init_file: str | None = None, timeout: float | None = 600.0) -> list:
    """Run ``fn(*args)`` as each rank of a fresh ``n_ranks`` process group
    on this host; returns the ranks' results in rank order.

    ``fn`` must be importable by name (processes start with ``spawn``) and
    return something picklable.  CPU ranks split the host's cores between
    them (``torch.set_num_threads``).  ``init_file`` is the rendezvous file
    (default: a new temporary directory's).  If a rank fails, or the ranks
    are not all done within ``timeout`` seconds (None: no limit), every
    rank still running is killed and ``RuntimeError`` raised with the
    failures.
    """
    import multiprocessing as mp
    kind = resolve_device(device).type
    backend = choose_backend(device, n_ranks, backend)
    with tempfile.TemporaryDirectory() as tmp:
        path = init_file or os.path.join(tmp, "rendezvous")
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n_ranks, backend, kind, "file://" + path,
                                   results, args))
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        errors: list[str] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while len(got) + len(errors) < n_ranks:
                try:
                    rank, ok, out = results.get(
                        timeout=None if deadline is None
                        else max(0.1, deadline - time.monotonic()))
                except queue_lib.Empty:
                    if not errors:
                        errors.append(f"timed out after {timeout:g} s with ranks "
                                      f"{sorted(set(range(n_ranks)) - set(got))} "
                                      "unfinished")
                    break
                if ok:
                    got[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    # the first failure is often a peer's lost connection:
                    # wait briefly for the one that caused it
                    deadline = time.monotonic() + 2.0
        finally:
            for p in procs:
                p.join(timeout=5.0 if not errors else 0.5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
    if errors:
        raise RuntimeError("spawned ranks failed: " + "\n".join(errors))
    return [got[r] for r in range(n_ranks)]


def add_mesh_args(ap) -> None:
    """The launchers' ``--mesh``, ``--ranks`` and ``--backend``."""
    ap.add_argument("--mesh", action="store_true",
                    help="shard over every rank: under torchrun each process "
                         "is one, otherwise --ranks are started here")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start for --mesh without torchrun "
                         "(default: one per card, 2 on the CPU)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend (default: nccl on the card, "
                         "gloo on the CPU; ranks that share a card need gloo)")


def spawn_launcher(main, args, argv) -> object:
    """Start a launcher's ``--mesh`` ranks, each running ``main(argv)``,
    and return rank 0's result.  On the card the kernels are built first
    (ranks never build them)."""
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build()
    return spawn(main, n, list(argv), device=args.device, backend=args.backend,
                 timeout=None)[0]
