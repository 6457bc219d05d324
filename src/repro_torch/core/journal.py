"""Run journal: crash-tolerant, append-only record of task completions.

Fault-tolerance contract for pipeline runs:

  * every task completion is appended (fsync'd) with its content-addressed
    cache key and output manifest BEFORE downstream tasks may consume it;
  * on restart, `recover()` returns completed task ids whose plan identity
    matches, so the scheduler re-executes only the missing suffix of the DAG
    (re-execution is idempotent: outputs are content-addressed);
  * a torn final line (crash mid-append) is detected and dropped.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List


class RunJournal:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")

    # -- writes -----------------------------------------------------------------
    def _append(self, record: Dict) -> None:
        record = dict(record, ts=time.time())
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._f.closed:
                return    # late event (e.g. speculation loser) after close
            self._f.write(line + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def record_plan(self, plan_id: str, run_id: str, order: List[str]) -> None:
        self._append({"kind": "plan", "plan_id": plan_id, "run_id": run_id,
                      "order": order})

    def record_task_start(self, plan_id: str, task_id: str, worker: str,
                          attempt: int) -> None:
        self._append({"kind": "start", "plan_id": plan_id, "task_id": task_id,
                      "worker": worker, "attempt": attempt})

    def record_task_done(self, plan_id: str, task_id: str, cache_key: str,
                         worker: str, duration_s: float,
                         output_rows: int, output_bytes: int) -> None:
        self._append({"kind": "done", "plan_id": plan_id, "task_id": task_id,
                      "cache_key": cache_key, "worker": worker,
                      "duration_s": duration_s, "output_rows": output_rows,
                      "output_bytes": output_bytes})

    def record_task_failed(self, plan_id: str, task_id: str, worker: str,
                           error: str) -> None:
        self._append({"kind": "failed", "plan_id": plan_id,
                      "task_id": task_id, "worker": worker,
                      "error": error[:2000]})

    def close(self) -> None:
        with self._lock:
            self._f.close()

    # -- recovery ---------------------------------------------------------------
    @staticmethod
    def recover(path: str, plan_id: str) -> Dict[str, Dict]:
        """Return {task_id: done-record} for the given plan id. Tolerates a
        torn last line and interleaved records from other plans."""
        done: Dict[str, Dict] = {}
        if not os.path.exists(path):
            return done
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn write at crash point
                if rec.get("plan_id") != plan_id:
                    continue
                if rec.get("kind") == "done":
                    done[rec["task_id"]] = rec
        return done
