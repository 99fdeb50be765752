"""Durable job state: the job store survives process restarts.

The port's copy of ``s2sr_tpu/server/persistence.py``: the store
journals every update to a JSONL file and reloads it on boot; jobs that
were mid-flight at crash time are marked failed-on-restart so clients
polling them terminate cleanly instead of hanging forever.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

from ..utils import setup_logging
from .jobs import JobStore

logger = setup_logging("s2sr_tpu_torch.persistence")

_ACTIVE_STATES = ("queued", "processing", "fetching", "tiling",
                  "tiling_original", "tiling_sr", "processing_sr")


class DurableJobStore(JobStore):
    """JobStore + append-only JSONL journal."""

    def __init__(self, journal_path: Path | str):
        super().__init__()
        self._journal_path = Path(journal_path)
        self._journal_lock = threading.Lock()
        replayed = self._replay()
        # Boot-time compaction: the journal appends one record per
        # status update for the life of the deployment, so replay cost
        # and disk grow without bound. After replay the in-memory store
        # IS the merged state — rewrite one record per job, atomically
        # (tmp + rename) so a crash mid-compaction can never lose the
        # old journal.
        if replayed > len(self._jobs):
            tmp = self._journal_path.with_suffix(".jsonl.tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                for job_id, job in self._jobs.items():
                    f.write(json.dumps({"_job_id": job_id, **job}) + "\n")
            tmp.replace(self._journal_path)
            logger.info("compacted journal: %d records -> %d jobs",
                        replayed, len(self._jobs))
        self._journal = open(self._journal_path, "a", encoding="utf-8")

    def _replay(self) -> int:
        """Merge journal records into the store; returns record count."""
        if not self._journal_path.exists():
            self._journal_path.parent.mkdir(parents=True, exist_ok=True)
            return 0
        count = 0
        for line in self._journal_path.read_text(encoding="utf-8").splitlines():
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            job_id = record.pop("_job_id", None)
            if job_id:
                self._jobs.setdefault(job_id, {}).update(record)
                count += 1
        # anything still "active" was interrupted by the restart
        for job_id, job in self._jobs.items():
            if job.get("status") in _ACTIVE_STATES:
                job["status"] = "failed"
                job["message"] = "interrupted by server restart"
        if count:
            logger.info("replayed %d journal records (%d jobs)",
                        count, len(self._jobs))
        return count

    def _append(self, job_id: str, fields: dict) -> None:
        record = {"_job_id": job_id}
        for key, value in fields.items():
            try:
                json.dumps(value)
                record[key] = value
            except TypeError:
                record[key] = str(value)
        with self._journal_lock:
            if self._journal.closed:
                # a job that outlived shutdown: its record is lost as in a
                # hard crash, and the next boot marks the job failed
                return
            self._journal.write(json.dumps(record) + "\n")
            self._journal.flush()

    def create(self, job_id: str, **fields):
        out = super().create(job_id, **fields)
        self._append(job_id, out)
        return out

    def update(self, job_id: str, **fields) -> bool:
        applied = super().update(job_id, **fields)
        if applied:
            # journal only updates that applied to a KNOWN job — the
            # runner's internal ids (e.g. run_sync's "_sync_*" items)
            # are never create()d, and journaling their failure records
            # would resurrect them as phantom jobs on the next boot
            self._append(job_id, fields)
        return applied

    def update_if(self, job_id: str, expected_status: str, **fields) -> bool:
        applied = super().update_if(job_id, expected_status, **fields)
        if applied:
            self._append(job_id, fields)
        return applied

    def close(self) -> None:
        """Close the journal (the app's last shutdown hook)."""
        with self._journal_lock:
            self._journal.close()
