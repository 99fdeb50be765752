"""Structured stage timing / profiling.

The reference has no tracing beyond wall-clock prints
(``server/app/generate_vectors.py:200,218``); clients regex-parse
"Stage i/n" strings. Here every pipeline reports structured progress:
stage name + index/total + elapsed seconds, and can optionally capture a
``torch.profiler`` trace per stage.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional

ProgressFn = Callable[[str, int, int, float], None]


@dataclass
class StageRecord:
    name: str
    index: int
    total: int
    seconds: float


@dataclass
class StageTimer:
    """Collects per-stage wall-clock timings for a pipeline run.

    ``on_progress(stage, index, total, fraction)`` fires at stage start so a
    job store can surface structured progress (instead of the reference's
    emoji log lines, ``server/app/main.py:333``).
    """

    total_stages: int = 0
    on_progress: Optional[ProgressFn] = None
    records: List[StageRecord] = field(default_factory=list)
    _start: float = field(default_factory=time.perf_counter)

    @contextlib.contextmanager
    def stage(self, name: str, profile_dir: Optional[str] = None) -> Iterator[None]:
        index = len(self.records) + 1
        total = max(self.total_stages, index)
        if self.on_progress is not None:
            self.on_progress(name, index, total, (index - 1) / max(total, 1))
        t0 = time.perf_counter()
        ctx = contextlib.nullcontext()
        if profile_dir is not None:
            ctx = _torch_trace(profile_dir)
        with ctx:
            yield
        self.records.append(StageRecord(name, index, total, time.perf_counter() - t0))

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def summary(self) -> dict:
        return {
            "total_seconds": round(self.elapsed, 3),
            "stages": [
                {"name": r.name, "index": r.index, "seconds": round(r.seconds, 3)}
                for r in self.records
            ],
        }


@contextlib.contextmanager
def _torch_trace(profile_dir: str) -> Iterator[None]:
    """CPU+CUDA ``torch.profiler`` window exported as a Chrome trace."""
    from pathlib import Path

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))


@contextlib.contextmanager
def stage_timer(total_stages: int = 0, on_progress: Optional[ProgressFn] = None):
    timer = StageTimer(total_stages=total_stages, on_progress=on_progress)
    yield timer
