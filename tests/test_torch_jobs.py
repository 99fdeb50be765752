"""The port's job store, runner and journal (``server/jobs.py``,
``server/persistence.py``) against the JAX package's, on the CPU.

Every wait in these tests is on an event or on the runner's own
condition (``JobRunner.join``), never on a sleep loop: the JAX test
``test_runner_stop_unblocks_queued_run_sync`` polls ``queued_count``
after submitting its blocker, and reads 2 under load when the worker has
not yet taken the blocker off the queue.
"""

import json
import sys
import threading

import pytest

from s2sr_tpu.server import jobs as jax_jobs
from s2sr_tpu.server import persistence as jax_persistence
from s2sr_tpu_torch.server import jobs
from s2sr_tpu_torch.server.persistence import DurableJobStore
from torch_threads import one_torch_thread  # noqa: F401

WAIT = 10.0


def started_blocker(runner, job_id="blocker"):
    """Submit a job that holds the worker; return (started, release)
    events once the worker runs it."""
    started, release = threading.Event(), threading.Event()

    def block():
        started.set()
        release.wait(WAIT)

    runner.submit(job_id, block)
    assert started.wait(WAIT)
    return started, release


def notify_on_submit(runner):
    """An event set each time ``runner.submit`` has enqueued an item."""
    queued = threading.Event()
    submit = runner.submit

    def wrapped(*args, **kwargs):
        out = submit(*args, **kwargs)
        queued.set()
        return out

    runner.submit = wrapped
    return queued


@pytest.mark.parametrize("mod", [jax_jobs, jobs], ids=["jax", "torch"])
def test_store_semantics(mod):
    store = mod.JobStore()
    rec = store.create("a", status="queued", message="m")
    assert set(rec) == {"created_at", "status", "message"}
    assert store.update("a", status="processing") is True
    assert store.update("ghost", status="failed") is False
    assert store.update_if("a", "queued", status="x") is False
    assert store.update_if("a", "processing", status="completed") is True
    store.create("pipeline_1", status="failed")
    assert store.count_by_status() == {"completed": 1, "failed": 1}
    assert list(store.with_prefix("pipeline_")) == ["pipeline_1"]
    assert "a" in store and "ghost" not in store
    copy = store.get("a")
    copy["status"] = "mutated"
    assert store.get("a")["status"] == "completed"
    assert set(store.all()) == {"a", "pipeline_1"}


def test_capacity_and_coalescing_match_jax():
    """The same submissions give the same capacity answers and the same
    batches in both runners."""
    traces = []
    for mod in (jax_jobs, jobs):
        store = mod.JobStore()
        runner = mod.JobRunner(store, max_concurrent=1)
        calls, answers = [], []
        gate, held = threading.Event(), threading.Event()
        answers.append(runner.submit(
            "hold", lambda: (held.set(), gate.wait(WAIT))))
        assert held.wait(WAIT)          # the worker has taken the blocker
        for i in range(5):
            store.create(f"j{i}")
            key = ("enhance", "m") if i != 3 else ("enhance", "x")
            answers.append(runner.submit(
                f"j{i}", lambda i=i: calls.append(f"single{i}"),
                coalesce_key=key, payload={"i": i},
                many_fn=lambda items: calls.append([j for j, _ in items])))
        answers.append(runner.has_capacity())
        answers.append(runner.queued_count)
        gate.set()
        runner.join(WAIT)
        answers.append((runner.active_count, runner.queued_count))
        runner.stop()
        traces.append((answers, calls))
    assert traces[1] == traces[0]
    answers, calls = traces[1]
    assert answers[:7] == [True, False, False, False, False, False, False]
    assert answers[7] == 5 and answers[8] == (0, 0)
    assert calls == [["j0", "j1", "j2"], "single3", "single4"]


def test_max_coalesce_caps_a_batch():
    store = jobs.JobStore()
    runner = jobs.JobRunner(store)
    _, release = started_blocker(runner)
    batches = []
    for i in range(6):
        runner.submit(f"j{i}", lambda: None, coalesce_key=("k",),
                      payload=i, many_fn=lambda items: batches.append(
                          [p for _, p in items]))
    release.set()
    runner.join(WAIT)
    assert batches == [[0, 1, 2, 3], [4, 5]]
    runner.stop()


def test_crashing_job_is_marked_failed():
    store = jobs.JobStore()
    runner = jobs.JobRunner(store)
    store.create("bad", status="queued")
    runner.submit("bad", lambda: 1 / 0)
    runner.join(WAIT)
    assert store.get("bad")["status"] == "failed"
    assert "division by zero" in store.get("bad")["message"]
    runner.stop()


def test_run_sync_result_error_and_timeout():
    store = jobs.JobStore()
    runner = jobs.JobRunner(store, max_concurrent=1)
    assert runner.run_sync(lambda: 41 + 1) == 42
    with pytest.raises(ZeroDivisionError):
        runner.run_sync(lambda: 1 / 0)
    _, release = started_blocker(runner)
    try:
        with pytest.raises(TimeoutError, match="device runner busy"):
            runner.run_sync(lambda: None, timeout=0.2, label="t")
    finally:
        release.set()
    runner.join(WAIT)
    assert store.all() == {}          # run_sync writes no record
    runner.stop()


def test_stop_releases_queued_run_sync():
    """A run_sync item still queued when stop() drains it releases its
    caller at once with RuntimeError, and leaves no record."""
    store = jobs.JobStore()
    runner = jobs.JobRunner(store, max_concurrent=1)
    _, release = started_blocker(runner)
    queued = notify_on_submit(runner)
    result: dict = {}

    def caller():
        try:
            runner.run_sync(lambda: "never", timeout=30, label="t")
        except RuntimeError as exc:
            result["exc"] = exc

    t = threading.Thread(target=caller)
    t.start()
    assert queued.wait(WAIT)
    assert runner.queued_count == 1 and runner.active_count == 1
    runner.stop(timeout=0.5)          # the worker is still in the blocker
    release.set()
    t.join(timeout=WAIT)
    assert not t.is_alive(), "run_sync caller still blocked after stop()"
    assert "shut down" in str(result["exc"])
    assert all(not k.startswith("_sync") for k in store.all())


def test_stop_marks_queued_jobs_failed_and_refuses_work():
    store = jobs.JobStore()
    runner = jobs.JobRunner(store, max_concurrent=1)
    store.create("j-queued", status="queued")
    _, release = started_blocker(runner)
    runner.submit("j-queued", lambda: store.update("j-queued",
                                                   status="completed"))
    runner.stop(timeout=0.2)
    release.set()
    assert store.get("j-queued")["status"] == "failed"
    assert store.get("j-queued")["message"] == "Server shut down before job ran"
    with pytest.raises(RuntimeError, match="shutting down"):
        runner.submit("late", lambda: None)
    runner.join(WAIT)                 # drained items count as finished


def test_join_waits_on_the_condition():
    store = jobs.JobStore()
    runner = jobs.JobRunner(store)
    _, release = started_blocker(runner)
    with pytest.raises(TimeoutError):
        runner.join(0.05)
    release.set()
    runner.join(WAIT)
    runner.stop()


def test_runner_stress_every_job_runs_once():
    """More workers than cores, a short switch interval: every job runs
    exactly once and the counts balance."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        store = jobs.JobStore()
        runner = jobs.JobRunner(store, max_concurrent=8)
        ran: list = []
        lock = threading.Lock()

        def job(i):
            with lock:
                ran.append(i)
            store.update(f"j{i}", status="completed")

        for i in range(400):
            store.create(f"j{i}", status="queued")
            runner.submit(f"j{i}", lambda i=i: job(i))
        runner.join(30)
        assert sorted(ran) == list(range(400))
        assert store.count_by_status() == {"completed": 400}
        assert runner.active_count == 0 and runner.queued_count == 0
        runner.stop()
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("mod", [jax_persistence, None], ids=["jax", "torch"])
def test_durable_store_journal_compaction_and_restart(tmp_path, mod):
    cls = DurableJobStore if mod is None else mod.DurableJobStore
    journal = tmp_path / "jobs.jsonl"
    store = cls(journal)
    store.create("done", status="queued", message="Job queued")
    store.update("done", status="processing")
    store.update("done", status="completed", result={"path": tmp_path})
    store.create("running", status="queued")
    store.update("running", status="tiling_sr")
    store.create("queued", status="queued")
    assert store.update("_sync_x", status="failed") is False
    assert store.update_if("queued", "processing", status="x") is False
    lines = journal.read_text().splitlines()
    assert len(lines) == 6
    # a value JSON cannot hold is journaled as its str()
    assert json.loads(lines[2])["result"] == str({"path": tmp_path})

    restarted = cls(journal)
    assert set(restarted.all()) == {"done", "running", "queued"}
    assert restarted.get("done")["status"] == "completed"
    for job_id in ("running", "queued"):
        job = restarted.get(job_id)
        assert (job["status"], job["message"]) == (
            "failed", "interrupted by server restart")
    # compacted on boot: one record per job
    assert len(journal.read_text().splitlines()) == 3
    assert not journal.with_suffix(".jsonl.tmp").exists()


def test_durable_store_matches_jax_and_closes(tmp_path):
    records = []
    for cls, name in ((jax_persistence.DurableJobStore, "jax"),
                      (DurableJobStore, "torch")):
        journal = tmp_path / name / "jobs.jsonl"
        store = cls(journal)
        store.create("a", status="queued")
        store.update("a", status="completed", message="ok")
        store.update_if("a", "completed", message="again")
        journal.write_text(journal.read_text() + "not json\n")
        again = cls(journal)
        rec = again.get("a")
        rec.pop("created_at")
        records.append(rec)
    assert records[1] == records[0] == {"status": "completed",
                                        "message": "again"}
    store = DurableJobStore(tmp_path / "c" / "jobs.jsonl")
    store.create("x", status="queued")
    store.close()
    assert store.update("x", status="processing") is True   # no raise
    assert DurableJobStore(tmp_path / "c" / "jobs.jsonl").get(
        "x")["status"] == "failed"
