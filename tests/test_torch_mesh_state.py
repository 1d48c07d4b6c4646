"""The port's mesh with a state dir on gloo ranks of the CPU (two ranks
spawned once on the (1, 2) mesh, held against ``repro``'s auditor and
store), the mesh store's lease, ``multihost.spawn``'s refusals and
failures, ``initialize_if_needed``, and the integrate launcher's own
ranks.  The ranks run as test_torch_mesh.py's docstring says."""

import hashlib
import os
import socket

import numpy as np
import pytest
import torch

from repro_torch.launch import multihost
from test_torch_mesh import R, _bits

torch.set_num_threads(1)


def _state_ranks(root):
    """The (1, 2) mesh with a state dir: the demo workload and an adaptive
    request (grid records, refits) served whole without one, then with one
    abandoned after its first wave (no close()), resumed by new engines,
    replayed warm, and an engine on a dir whose lease a live foreign
    process holds."""
    import json
    import shutil

    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.core import genz
    from repro_torch.kernels import template
    from repro_torch.launch import serve_integrals
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.service import IntegrationEngine, IntegrationRequest, LeaseHeld
    from repro_torch.service.faults import FaultPlan

    mesh = make_mesh_for(model_parallel=2, device="cpu")
    reqs = serve_integrals.demo_workload(4, n_fn=4, n_samples=4 * R)
    reqs.append(IntegrationRequest.make((genz.corner_peak(2, 2)[0],),
                                        target_stderr=3e-4, adaptive=True))
    kw = dict(round_samples=R, device="cpu", mesh=mesh, max_rounds_per_wave=2,
              adapt_pilot_samples=1024, adapt_rounds_per_epoch=1)
    state = os.path.join(root, "state")
    out = {"pid": os.getpid(), "rank": dist.get_rank()}

    def serve(engine, waves=None):
        template.reset_launch_count()
        tickets = [engine.submit(r) for r in reqs]
        done = 0
        while (waves is None or done < waves) and engine.step():
            done += 1
        got = [engine.poll(t) for t in tickets]
        return ([(r.means, r.stderrs) for r in got if r is not None],
                template.launch_count(), done)

    engine = IntegrationEngine(**kw)
    out["whole"] = serve(engine)
    engine.close()
    engine = IntegrationEngine(state_dir=state, **kw)
    out["abandoned"] = serve(engine, waves=1)
    with open(os.path.join(state, "lease.json")) as f:
        out["lease_pid"] = json.load(f)["pid"]
    if out["rank"] == 0:
        shutil.copytree(state, os.path.join(root, "abandoned"))
    del engine                 # no close(): no snapshot, the lease left behind
    engine = IntegrationEngine(state_dir=state, **kw)
    out["resumed"] = serve(engine)
    out["cache"] = {c: (e.fn_offset, e.s1, e.s2, e.n, e.rounds_done)
                    for c, e in engine.cache._entries.items()}
    engine.close()
    engine = IntegrationEngine(state_dir=state, **kw)
    out["replay"] = serve(engine)
    engine.close()
    try:
        IntegrationEngine(state_dir=os.path.join(root, "held"), **kw)
    except LeaseHeld as exc:
        out["lease_held"] = str(exc)
    # rank 0's first journal fsync fails (the first submit's alloc record):
    # rank 1, which writes nothing, raises the same error
    plan = FaultPlan({"wal_fsync": 0}) if out["rank"] == 0 else None
    engine = IntegrationEngine(state_dir=os.path.join(root, "fsync"), faults=plan, **kw)
    try:
        engine.submit(reqs[0])
    except OSError as exc:
        out["fsync_failed"] = (type(exc).__name__, str(exc))
    return out


def _fail_on_rank_one():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """The state-dir spawn; the test process holds a live lease on
    ``held/`` (its own pid, 10 minutes) before the ranks start."""
    import json
    import time
    d = tmp_path_factory.mktemp("state")
    (d / "held").mkdir()
    now = time.time()
    (d / "held" / "lease.json").write_text(json.dumps(
        {"token": "test", "pid": os.getpid(), "acquired": now, "expires": now + 600}))
    out = multihost.spawn(_state_ranks, 2, str(d), device="cpu",
                          init_file=str(d / "rendezvous"), timeout=240)
    return out, d


def _digest(served):
    return hashlib.sha256(b"".join(np.ascontiguousarray(a, np.float32).tobytes()
                                   for pair in served[0] for a in pair)).hexdigest()


def test_mesh_state_dir_resumes_bit_for_bit(state):
    """Rank 0 owns the dir: abandoned after wave 1 and resumed by new
    engines, the served means and stderrs are sha256-equal to the run
    without a state dir on both ranks, the resumed run launches only the
    remaining waves, a warm replay none, and lease.json only ever names
    rank 0's pid."""
    out, _ = state
    whole = _digest(out[0]["whole"])
    for o in out:
        assert _digest(o["whole"]) == _digest(o["resumed"]) == _digest(o["replay"]) == whole
        assert o["abandoned"][2] == 1 and o["abandoned"][0] == []
        assert o["abandoned"][1] + o["resumed"][1] == o["whole"][1]
        assert o["resumed"][2] == o["whole"][2] - 1
        assert o["replay"][1:] == (0, 0)
        assert o["lease_pid"] == out[0]["pid"]
    assert out[1]["pid"] != out[0]["pid"]


@pytest.mark.parametrize("which", ["abandoned", "state"])
def test_mesh_state_dir_audits_clean_in_both_auditors(state, which):
    """The dir the mesh wrote (as abandoned: journal records, the adaptive
    request's grid among them, written by rank 0 before its stream's
    alloc; after the resumed run's close: a snapshot) is clean to the
    port's auditor and to the reference's, with the same counts."""
    from repro.analysis.streams import audit_state_dir as ref_audit
    from repro_torch.analysis.streams import audit_state_dir
    from repro_torch.service.store import read_journal
    path = str(state[1] / which)
    got, want = audit_state_dir(path), ref_audit(path)
    assert got.violations == [] and want.violations == []
    assert (got.streams, got.journal_records, got.deposits_folded) == \
        (want.streams, want.journal_records, want.deposits_folded)
    assert got.streams >= 4
    if which == "abandoned":
        records, _ = read_journal(os.path.join(path, "journal.bin"))
        assert got.deposits_folded > 0 and any(r["t"] == "grid" for r in records)


def test_reference_store_recovers_the_mesh_dir(state):
    """repro's DurableStore recovers the mesh's dir with the entries the
    port's store recovers and the resumed ranks held, bit for bit, and
    the same grid chain."""
    from repro.service.store import DurableStore as RefStore
    from repro_torch.service.store import DurableStore
    out, d = state
    ref = RefStore(str(d / "state"), fsync=False, lease_ttl=None).load()
    port = DurableStore(str(d / "state"), fsync=False, lease_ttl=None).load()
    assert ref.next_id == port.next_id and sorted(ref.entries) == sorted(port.entries)
    assert sorted(out[0]["cache"]) == sorted(ref.entries)
    for chash, ent in ref.entries.items():
        mine = port.entries[chash]
        off, s1, s2, n, done = out[0]["cache"][chash]
        assert (ent.fn_offset, ent.n, ent.rounds_done) == (mine.fn_offset, mine.n,
                                                         mine.rounds_done) == (off, n, done)
        for a, b, c in ((ent.s1, mine.s1, s1), (ent.s2, mine.s2, s2)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
            np.testing.assert_array_equal(_bits(a), _bits(c))
    assert sorted(ref.grids) == sorted(port.grids) and len(ref.grids) >= 2
    for chash, g in ref.grids.items():
        assert (g.parent, g.epoch) == (port.grids[chash].parent, port.grids[chash].epoch)
        np.testing.assert_array_equal(_bits(g.edges), _bits(port.grids[chash].edges))


def test_rank0_store_failures_fail_every_rank(state):
    """A live foreign lease (the test process's) fails rank 0's open of
    the dir, and rank 1, which never reads it, raises the same LeaseHeld
    instead of waiting in the next collective; so does a failed journal
    fsync on rank 0."""
    out, _ = state
    assert out[0]["lease_held"] == out[1]["lease_held"]
    assert f"leased to pid {os.getpid()}" in out[0]["lease_held"]
    assert out[0]["fsync_failed"] == out[1]["fsync_failed"]
    assert out[0]["fsync_failed"][0] == "InjectedIOError"


def test_mesh_store_raises_a_lost_lease_at_the_next_operation(tmp_path):
    """The worker loop's lease renewal is rank 0's alone (no collective):
    a lease taken over in between does not raise there, but at the next
    store operation, which every rank runs (here a world of one)."""
    import json
    import time

    import torch.distributed as dist
    from repro_torch.service.store import LeaseLost, MeshStore
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            rank=0, world_size=1)
    try:
        store = MeshStore(str(tmp_path / "s"), fsync=False, lease_ttl=1e-3)
        (tmp_path / "s" / "lease.json").write_text(json.dumps(
            {"token": "usurper", "pid": os.getpid(), "acquired": 0.0, "expires": 1e12}))
        time.sleep(0.01)
        store.heartbeat()
        with pytest.raises(LeaseLost, match="usurper|belongs to"):
            store.append_alloc("aaa", fn_offset=0, n_fn=1, round_samples=R)
    finally:
        dist.destroy_process_group()


def test_spawn_defaults_to_the_card(monkeypatch):
    """Without a device, spawn asks for the card and raises on a host
    without one, as resolve_device does, before starting any rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.spawn(_fail_on_rank_one, 2)


def test_spawn_reports_the_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails"):
        multihost.spawn(_fail_on_rank_one, 2, device="cpu",
                        init_file=str(tmp_path / "rendezvous"), timeout=120)


def test_initialize_if_needed_from_the_environment(monkeypatch):
    """No environment: a single-process run.  repro's REPRO_COORD,
    REPRO_NUM_PROCS and REPRO_PROC_ID (here a world of one on localhost):
    a gloo group on the CPU.  NCCL on the CPU is refused."""
    import torch.distributed as dist
    for var in ("REPRO_COORD", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_if_needed(device="cpu") is False
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("REPRO_COORD", f"127.0.0.1:{port}")
    monkeypatch.setenv("REPRO_NUM_PROCS", "1")
    monkeypatch.setenv("REPRO_PROC_ID", "0")
    assert multihost.initialize_if_needed(verbose=False, device="cpu") is True
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert multihost.initialize_if_needed(device="cpu") is True
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="NCCL runs on the card"):
        multihost.choose_backend("cpu", 1, "nccl")


def test_integrate_launcher_spawns_its_ranks(tmp_path):
    """``integrate --mesh`` without torchrun starts --ranks processes, a
    (1, 2) mesh: functions over two model shards.  The mesh run is a child
    process with a time limit (test_torch_lm_train.bounded_main)."""
    from repro_torch.launch import integrate
    from test_torch_lm_train import bounded_main
    argv = ["--device", "cpu", "--n-functions", "8", "--samples", "4096",
            "--trials", "2", "--rounds", "1", "--use-kernel"]
    assert bounded_main("repro_torch.launch.integrate", argv + ["--mesh", "--ranks", "2"],
                        tmp_path) == integrate.main(argv)
