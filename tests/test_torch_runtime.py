"""The wall-clock runtime of the port (``repro_torch.runtime``: the
upload queue, the client pool, the clocks, ``TrafficRecorder`` /
``Recording``, ``IngestEngine``, ``launch.ingest``) against the JAX
reference on the CPU, at the size of ``test_torch_stream.py`` (n = 12,
a quadratic loss, 4-6 rounds).

Recordings are the reference's JSON: one made by the reference (virtual
clock) loads in the port and its replay gives the recorded History
digest, and a wall-clock recording made by the port replays in the
reference to the same digest.  Params hashes follow ``jax.tree.leaves``
order and equal the reference's on equal values.  Inside the port: the
virtual clock equals ``StreamEngine`` bitwise; wall-clock runs, with and
without overlapping dispatch, replay bitwise from their recordings
(``Recording.verify() == []``, across JSON too); a zero-latency wall run
equals ``LocalEngine``; the queue's drop policies are deterministic; a
``wall_budget`` stop leaves a loadable, verifiable prefix; a worker's
exception is raised on the server thread, not lost; snapshots stay
unchanged.

Wall-clock assertions rest on the guarded commit, which holds under any
load, never on timing: ``time_scale`` is small, runs are a few rounds,
and every wall-clock test runs its body on a thread it joins with a
time limit (``_within``), so a hang fails the test instead of the run.
"""

import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import ExecutionConfig as JExec
from repro.fl import make_engine as jmake_engine
from repro.fl import parse_fault_spec as jparse_fault_spec
from repro.fl.stream import StreamConfig as JStreamConfig
from repro.runtime import Recording as JRecording
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import Upload as JUpload
from repro.runtime import UploadQueue as JUploadQueue
from repro.runtime import history_digest as jhistory_digest
from repro.runtime import params_sha256 as jparams_sha256
from repro_torch.fl import stream as tstream
from repro_torch.fl.engine import ExecutionConfig, LocalEngine, make_engine
from repro_torch.fl.faults import FaultSpec, parse_fault_spec, sample_trace
from repro_torch.fl.stream import StreamConfig, StreamEngine
from repro_torch.launch import ingest as ingest_cli
from repro_torch.runtime import (ClientPool, IngestEngine, Recording,
                                 RuntimeConfig, Upload, UploadQueue,
                                 history_digest, ingest, params_sha256)

from test_torch_stream import _problem, jquad_loss, quad_loss

jax.config.update("jax_enable_x64", False)

FAULTS = ("markov:p_fail=0.2,latency=exponential,mean=2.0,"
          "duplicate_rate=0.1")
POLICY = dict(buffer=8, deadline=0.8, staleness="poly", max_staleness=4,
              fault_seed=5)
FAULTY = StreamConfig(faults=parse_fault_spec(FAULTS), **POLICY)
JFAULTY = JStreamConfig(faults=jparse_fault_spec(FAULTS), **POLICY)
WALL = RuntimeConfig(clock="wall", time_scale=0.02, workers=4)
LIMIT = 60.0        # seconds a wall-clock test may take


def _within(fn, seconds=LIMIT):
    """``fn()`` on a daemon thread, joined with a time limit: its result,
    or its exception re-raised here; a hang fails the test."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:         # noqa: BLE001 -- re-raised
            out["error"] = e

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"did not finish within {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _engine(backend, stream, runtime):
    return make_engine(ExecutionConfig(backend=backend, stream=stream,
                                       runtime=runtime), quad_loss,
                       device="cpu")


def _rows(h):
    return [(r.t, r.m, r.m_actual, r.d2s, r.d2d, r.stream)
            for r in h.records], h.ledger.total_d2s, h.ledger.total_d2d


# ---------------------------------------------------------------------------
# virtual clock: IngestEngine degenerates to StreamEngine bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["einsum", "aggregate"])
def test_virtual_clock_matches_stream_engine_bitwise(backend):
    plan, params, batches = _problem()[:3]
    e1 = _engine(backend, FAULTY, None)
    assert isinstance(e1, StreamEngine) and not isinstance(e1, IngestEngine)
    p1, h1 = e1.execute(plan, params, batches)
    e2 = _engine(backend, FAULTY, RuntimeConfig(clock="virtual"))
    assert isinstance(e2, IngestEngine)
    p2, h2 = e2.execute(plan, params, batches)
    assert torch.equal(p1["x"], p2["x"]) and _rows(h1) == _rows(h2)
    assert e1.last_closures == e2.last_closures
    rec = e2.last_recording
    assert rec.meta["rounds_done"] == plan.n_rounds
    assert rec.verify(quad_loss, params, batches, backend=backend,
                      device="cpu") == []


def test_virtual_clock_overlap_flag_is_inert():
    plan, params, batches = _problem(K=4)[:3]
    runs = [_engine("einsum", FAULTY, RuntimeConfig(
        clock="virtual", overlap=overlap)).execute(plan, params, batches)
        for overlap in (True, False)]
    assert torch.equal(runs[0][0]["x"], runs[1][0]["x"])
    assert _rows(runs[0][1]) == _rows(runs[1][1])


# ---------------------------------------------------------------------------
# the wall clock: zero latency == LocalEngine; recordings replay bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["einsum", "aggregate"])
def test_zero_latency_wall_matches_local_engine(backend):
    plan, params, batches = _problem(K=4)[:3]
    pl, hl = LocalEngine(quad_loss, ExecutionConfig(backend=backend),
                         device="cpu").execute(plan, params, batches)
    e = _engine(backend, StreamConfig(), WALL)
    pw, hw = _within(lambda: e.execute(plan, params, batches))
    assert torch.equal(pl["x"], pw["x"])
    assert [row[:5] for row in _rows(hl)[0]] == \
        [row[:5] for row in _rows(hw)[0]]
    assert e.last_recording.plan.source == "measured"
    # every cohort's payload was computed off the server thread, then
    # discarded by its pristine closure (no device event on the CPU)
    assert e.last_payload_ready == dict.fromkeys(range(plan.n_rounds), None)


@pytest.mark.parametrize("backend", ["einsum", "fused"])
@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlap", "serial"])
def test_wall_recording_replays_bitwise(overlap, backend):
    plan, params, batches = _problem()[:3]
    e = _engine(backend, FAULTY, dataclasses.replace(WALL, overlap=overlap))
    p_live, h_live = _within(lambda: e.execute(plan, params, batches))
    rec = e.last_recording
    assert rec.meta["overlap"] is overlap and rec.meta["clock"] == "wall"
    assert rec.meta["history"] == history_digest(h_live)
    assert rec.meta["params_sha256"] == params_sha256(p_live)
    assert rec.plan.source == "measured"
    assert any(r.stream for r in h_live.records)
    assert rec.verify(quad_loss, params, batches, backend=backend,
                      device="cpu") == []
    rt = Recording.from_json(rec.to_json())
    assert rt.verify(quad_loss, params, batches, backend=backend,
                     device="cpu") == []
    assert len(e.last_payload_ready) == (plan.n_rounds if overlap else 0)


def test_wall_recording_replays_across_backends():
    plan, params, batches = _problem(K=4)[:3]
    e = _engine("aggregate", FAULTY, WALL)
    _within(lambda: e.execute(plan, params, batches))
    assert e.last_recording.verify(quad_loss, params, batches,
                                   backend="aggregate", device="cpu") == []


def test_client_optim_wall_recording_replays_bitwise():
    plan, params, batches = _problem(K=4)[:3]
    S = dataclasses.replace(FAULTY, client_optim="sgd,adam")
    e = _engine("einsum", S, WALL)
    _within(lambda: e.execute(plan, params, batches))
    assert e.last_recording.stream["client_optim"] == "sgd,adam"
    assert e.last_recording.verify(quad_loss, params, batches,
                                   device="cpu") == []


# ---------------------------------------------------------------------------
# recordings cross between the packages
# ---------------------------------------------------------------------------

def test_reference_recording_replays_in_the_port():
    plan, params, batches, jplan, jparams, jbatches = _problem()
    jeng = jmake_engine(JExec(backend="aggregate", stream=JFAULTY,
                              runtime=JRuntimeConfig(clock="virtual")),
                        jquad_loss)
    jp, jh = jeng.execute(jplan, jparams, jbatches)
    text = jeng.last_recording.to_json()
    rec = Recording.from_json(text)
    assert rec.to_json() == text
    final, history = rec.replay(quad_loss, params, batches,
                                backend="fused", device="cpu")
    assert history_digest(history) == rec.meta["history"] == \
        jhistory_digest(jh)
    np.testing.assert_allclose(final["x"].numpy(), np.asarray(jp["x"]),
                               rtol=1e-4, atol=1e-5)


def test_port_wall_recording_replays_in_the_reference():
    plan, params, batches, jplan, jparams, jbatches = _problem()
    e = _engine("aggregate", FAULTY, WALL)
    p, _ = _within(lambda: e.execute(plan, params, batches))
    rec = JRecording.from_json(e.last_recording.to_json())
    final, history = rec.replay(jquad_loss, jparams, jbatches,
                                backend="aggregate")
    assert jhistory_digest(history) == rec.meta["history"]
    np.testing.assert_allclose(np.asarray(final["x"]), p["x"].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_params_hash_follows_the_reference():
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "a": {"z": rng.standard_normal(2).astype(np.float32),
                  "y": np.arange(4, dtype=np.int32)}}
    port = jax.tree.map(torch.as_tensor, tree)
    ref = jax.tree.map(jnp.asarray, tree)
    assert params_sha256(port) == jparams_sha256(ref)
    # bf16 leaves hash as their int16 bit pattern (numpy has no bf16)
    bf = torch.as_tensor(tree["w"]).to(torch.bfloat16)
    assert params_sha256({"w": bf}) == \
        jparams_sha256({"w": jnp.asarray(bf.view(torch.int16).numpy())})
    assert params_sha256({"w": bf}) != params_sha256({"w": bf + 1})


# ---------------------------------------------------------------------------
# the queue and the pool
# ---------------------------------------------------------------------------

def _uploads(k):
    return [Upload(round=0, client=i, wall=float(i)) for i in range(k)]


@pytest.mark.parametrize("policy,landed,dropped,accepted", [
    ("drop_oldest", [2, 3, 4], [0, 1], [True] * 5),
    ("reject", [0, 1, 2], [3, 4], [True, True, True, False, False])])
def test_queue_drop_policy_is_deterministic(policy, landed, dropped,
                                            accepted):
    q = UploadQueue(capacity=3, policy=policy)
    assert [q.put(u) for u in _uploads(5)] == accepted
    got_landed, got_dropped = q.drain()
    assert [u.client for u in got_landed] == landed
    assert [u.client for u in got_dropped] == dropped
    assert q.drain() == ([], [])


def test_queue_force_put_and_close():
    q = UploadQueue(capacity=1, policy="reject")
    assert q.put(_uploads(1)[0]) is True
    assert q.put(Upload(0, 9, 9.0), force=True) is True
    assert [u.client for u in q.drain()[0]] == [0, 9]
    q = UploadQueue(capacity=1, policy="block")
    q.put(Upload(0, 0, 0.0))
    q.close()
    assert q.put(Upload(0, 1, 1.0)) is True and len(q) == 2


@pytest.mark.parametrize("policy", ["drop_oldest", "reject"])
def test_queue_seeded_load_equals_the_reference(policy):
    def run(Q, U):
        rng = np.random.default_rng(42)
        q = Q(capacity=4, policy=policy)
        for k in range(40):
            q.put(U(int(rng.integers(4)), int(rng.integers(12)), float(k)))
            if rng.random() < 0.3:
                q.drain()
        landed, dropped = q.drain()
        return ([(u.round, u.client) for u in landed],
                [(u.round, u.client) for u in dropped])

    assert run(UploadQueue, Upload) == run(UploadQueue, Upload) == \
        run(JUploadQueue, JUpload)


def test_pool_primes_every_thread_and_joins_after_a_failure():
    pool = ClientPool(UploadQueue(), time_scale=0.01, workers=3)
    seen = []
    _within(lambda: pool.prime(
        lambda: seen.append(threading.current_thread().name)))
    assert len(seen) == 4 and len(set(seen)) == 4

    def boom():
        raise RuntimeError("client died")

    _, fut = pool.dispatch(0, [(1, 0.5), (2, 1.0)], train_fn=boom)
    # the job fails before the shutdown starts: ``finish`` cancels a job
    # that no thread has taken yet, which a loaded host may leave queued
    assert isinstance(fut.exception(timeout=LIMIT), RuntimeError)
    _within(pool.finish)
    landed, _ = pool.queue.drain()
    assert sorted(u.client for u in landed) == [1, 2]


def test_runtime_config_validation():
    for bad in (dict(clock="sundial"), dict(time_scale=0.0),
                dict(workers=0), dict(queue_capacity=0),
                dict(drop_policy="shred"), dict(wall_budget=0.0)):
        with pytest.raises(ValueError):
            RuntimeConfig(**bad)


def test_runtime_wiring_and_refusals():
    with pytest.raises(ValueError, match="stream"):
        make_engine(ExecutionConfig(runtime=RuntimeConfig()), quad_loss,
                    device="cpu")
    e = _engine("einsum", StreamConfig(), RuntimeConfig(clock="virtual"))
    plan, params, batches = _problem(K=2)[:3]
    trace = sample_trace(FaultSpec(), plan.n_clients, plan.n_rounds, seed=0)
    with pytest.raises(ValueError, match="replay"):
        e.execute(plan, params, batches, trace=trace)
    with pytest.raises(ValueError, match="ingestion"):
        e.execute_controlled(None, params, batches)


# ---------------------------------------------------------------------------
# degradation, shutdown, failures
# ---------------------------------------------------------------------------

def test_wall_run_with_reject_policy_itemizes_drops():
    plan, params, batches = _problem(K=5)[:3]
    e = _engine("einsum", FAULTY, dataclasses.replace(
        WALL, queue_capacity=1, drop_policy="reject"))
    _, h = _within(lambda: e.execute(plan, params, batches))
    assert len(h.records) == plan.n_rounds
    rec = e.last_recording
    for r, i in rec.meta["drops"]:
        assert 0 <= r < plan.n_rounds and 0 <= i < plan.n_clients
        assert math.isinf(float(np.asarray(rec.plan.arrival_t)[r, i]))


def test_wall_budget_stop_flushes_a_loadable_prefix(tmp_path):
    plan, params, batches = _problem(K=40)[:3]
    e = _engine("einsum", FAULTY, RuntimeConfig(
        clock="wall", time_scale=0.05, wall_budget=0.6))
    _, h = _within(lambda: e.execute(plan, params, batches))
    done = len(h.records)
    assert 0 < done < plan.n_rounds, "the budget should stop mid-plan"
    rec = e.last_recording
    assert rec.meta["rounds_done"] == done == rec.plan.n_rounds
    path = tmp_path / "rec.json"
    rec.save(str(path))
    assert Recording.load(str(path)).verify(quad_loss, params, batches,
                                            device="cpu") == []


@pytest.mark.parametrize("stream", [StreamConfig(), FAULTY],
                         ids=["discarded", "consumed"])
def test_worker_exception_is_raised_not_lost(stream):
    """Round 2's payload job fails on its worker thread.  A pristine
    closure discards that future (the reference never reads it); the
    port raises its exception on the server thread all the same, and
    joins every thread."""
    plan, params, batches = _problem()[:3]
    e = _engine("einsum", stream, WALL)
    target = batches[2][0]
    packed = e._packed_payload

    def failing(snapshot, batch, eta):
        if batch[0] is target:
            raise RuntimeError("client 2 died")
        return packed(snapshot, batch, eta)

    e._packed_payload = failing
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="client 2 died"):
        _within(lambda: e.execute(plan, params, batches))
    assert threading.active_count() <= before


def test_every_upload_lands_once_under_thread_stress():
    """More training threads than cores and a short switch interval:
    every upload the realized plan schedules lands exactly once (a
    finite measured arrival; none where none was scheduled) and the
    recording still replays bitwise."""
    import sys
    plan, params, batches = _problem(K=8)[:3]
    e = _engine("einsum", FAULTY, dataclasses.replace(WALL, workers=16))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _within(lambda: e.execute(plan, params, batches))
    finally:
        sys.setswitchinterval(interval)
    planned = plan.with_faults(e.last_trace)
    want = ((planned.tau_t * planned.active_t > 0)
            & np.isfinite(planned.arrival_t))
    rec = e.last_recording
    assert np.array_equal(np.isfinite(rec.plan.arrival_t), want)
    assert rec.meta["drops"] == []
    assert rec.verify(quad_loss, params, batches, device="cpu") == []


def test_wall_run_leaves_the_snapshots_unchanged(monkeypatch):
    books = []

    @dataclasses.dataclass
    class Watched(tstream._Cohort):
        def __post_init__(self):
            books.append((self.snapshot,
                          {k: v.clone() for k, v in self.snapshot.items()}))

    monkeypatch.setattr(ingest, "_Cohort", Watched)
    plan, params, batches = _problem()[:3]
    e = _engine("aggregate", FAULTY, WALL)
    _, h = _within(lambda: e.execute(plan, params, batches))
    assert any(r.stream and r.stream.get("late") for r in h.records)
    assert len(books) == plan.n_rounds + 1        # + the warm-up's
    for snap, copy in books:
        assert all(torch.equal(snap[k], copy[k]) for k in copy)


def test_ingest_cli_selfcheck_and_replay(tmp_path, capsys):
    assert _within(lambda: ingest_cli.main(
        ["--selfcheck", "--device", "cpu", "--backend", "fused"])) == 0
    assert "all OK" in capsys.readouterr().out
    rec = tmp_path / "rec.json"
    args = ["--device", "cpu", "--model", "logreg", "--rounds", "3",
            "--n", "10", "--clusters", "2", "--k-min", "2", "--k-max", "3",
            "--samples", "300", "--T", "2", "--batch", "4", "--quiet",
            "--buffer", "6", "--deadline-ms", "20", "--time-scale", "0.02",
            "--faults", "markov:p_fail=0.2,latency=exponential,mean=0.8"]
    assert _within(lambda: ingest_cli.main(
        args + ["--record-out", str(rec)])) == 0
    assert _within(lambda: ingest_cli.main(args + ["--replay",
                                                   str(rec)])) == 0
    assert "replay OK" in capsys.readouterr().out
