"""Slow-start concurrent task runner.

Mirror of the reference's RunConcurrentlyWithSlowStart
(`operator/internal/utils/concurrent.go:72-96`): tasks run in batches of
doubling size (1, 2, 4, ...) so a systemic failure (apiserver throttling
there; a poisoned expansion or a broken downstream here) is detected after
one cheap task instead of a full-width burst. Within a batch, tasks run on a
bounded thread pool.

Used for work that is safe to parallelize: pure computation (workload
expansion) and external I/O (watch-driver event fan-out). The in-memory
store itself stays single-writer by design (SURVEY.md §5.2).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Sequence


@dataclass
class TaskResult:
    index: int
    value: Any = None
    error: BaseException | None = None


def run_concurrently_with_slow_start(
    tasks: Sequence[Callable[[], Any]],
    max_workers: int = 1,
    initial_batch: int = 1,
    stop_on_error: bool = True,
) -> list[TaskResult]:
    """Run `tasks`, doubling the batch size after each fully-successful batch.

    Returns one TaskResult per task that RAN, in task order. With
    `stop_on_error`, a failing batch records its own errors and the remaining
    tasks are never started — they simply have no TaskResult in the returned
    list (compare indices against range(len(tasks)) to find them).
    """
    results: list[TaskResult] = []
    max_workers = max(1, int(max_workers))
    batch = max(1, int(initial_batch))
    i = 0
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        while i < len(tasks):
            chunk = tasks[i : i + batch]

            def _run(idx_fn):
                idx, fn = idx_fn
                try:
                    return TaskResult(index=idx, value=fn())
                except BaseException as e:  # captured, not raised: batch policy
                    return TaskResult(index=idx, error=e)

            chunk_results = list(pool.map(_run, list(enumerate(chunk, start=i))))
            results.extend(chunk_results)
            if stop_on_error and any(r.error is not None for r in chunk_results):
                break
            i += len(chunk)
            batch *= 2  # slow start: 1, 2, 4, 8, ...
    return results
