"""Job status stores for the remote API.

The port's own copy of ``audio_separator_tpu/remote/job_store.py``.

The reference persists job status in Modal Dict / Firestore
(ref: remote/job_store.py:14-73, deploy_modal.py:212-228). Here the same
interface is provided by an in-memory store (single server) and a filesystem
store (shared volume / multi-worker); a Firestore adapter can slot in where
google-cloud libraries are available.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional


class InMemoryJobStore:
    def __init__(self):
        self._jobs: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def set_job_status(self, task_id: str, status_data: dict) -> None:
        with self._lock:
            self._jobs[task_id] = {**status_data, "_updated_at": time.time()}

    def get_job_status(self, task_id: str) -> Optional[dict]:
        with self._lock:
            data = self._jobs.get(task_id)
            return dict(data) if data else None

    def update_job_status(self, task_id: str, updates: dict) -> None:
        with self._lock:
            job = self._jobs.setdefault(task_id, {})
            job.update(updates)
            job["_updated_at"] = time.time()

    def delete_job(self, task_id: str) -> None:
        with self._lock:
            self._jobs.pop(task_id, None)

    def cleanup_old_jobs(self, max_age_seconds: float = 86400.0) -> int:
        """Drop stale jobs (ref: job_store.py:55-73)."""
        cutoff = time.time() - max_age_seconds
        removed = 0
        with self._lock:
            for task_id in list(self._jobs):
                if self._jobs[task_id].get("_updated_at", 0) < cutoff:
                    del self._jobs[task_id]
                    removed += 1
        return removed


class FileJobStore(InMemoryJobStore):
    """Persist job status as JSON files under a directory."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, task_id: str) -> str:
        safe = "".join(c for c in task_id if c.isalnum() or c in "-_")
        return os.path.join(self.root, f"{safe}.json")

    def set_job_status(self, task_id: str, status_data: dict) -> None:
        super().set_job_status(task_id, status_data)
        with self._lock:
            # Persist the stamped copy so age-based cleanup works after a
            # restart (files without _updated_at would never expire).
            data = dict(self._jobs.get(task_id, status_data))
            with open(self._path(task_id), "w", encoding="utf-8") as f:
                json.dump(data, f)

    def get_job_status(self, task_id: str) -> Optional[dict]:
        data = super().get_job_status(task_id)
        if data is not None:
            return data
        try:
            with open(self._path(task_id), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def update_job_status(self, task_id: str, updates: dict) -> None:
        # Atomic read-modify-write: concurrent progress updates from worker
        # threads must not drop each other's fields.
        with self._lock:
            job = self._jobs.get(task_id)
            if job is None:  # post-restart: rehydrate from disk
                try:
                    with open(self._path(task_id), encoding="utf-8") as f:
                        job = json.load(f)
                except (FileNotFoundError, json.JSONDecodeError):
                    job = {}
                self._jobs[task_id] = job
            job.update(updates)
            job["_updated_at"] = time.time()
            with open(self._path(task_id), "w", encoding="utf-8") as f:
                json.dump(job, f)

    def delete_job(self, task_id: str) -> None:
        super().delete_job(task_id)
        try:
            os.remove(self._path(task_id))
        except FileNotFoundError:
            pass

    def cleanup_old_jobs(self, max_age_seconds: float = 86400.0) -> int:
        removed = super().cleanup_old_jobs(max_age_seconds)
        # Also sweep on-disk jobs from previous processes.
        cutoff = time.time() - max_age_seconds
        for name in os.listdir(self.root):
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.root, name)
            try:
                with open(path, encoding="utf-8") as f:
                    stamp = json.load(f).get("_updated_at", os.path.getmtime(path))
                if stamp < cutoff:
                    os.remove(path)
                    removed += 1
            except (OSError, json.JSONDecodeError):
                continue
        return removed


class FirestoreJobStore(InMemoryJobStore):
    """Firestore-backed store so any serving instance can read/write status
    (ref: remote/job_store.py:14-73 — same collection layout and stale-job
    cleanup semantics, adapted to this package's store interface).

    Requires ``google-cloud-firestore``; the client import is deferred to
    construction so the module stays importable without it. ``client`` can be
    injected (tests / emulators).
    """

    COLLECTION = "audio_separation_jobs"

    def __init__(self, project: Optional[str] = None, client=None,
                 collection: Optional[str] = None):
        super().__init__()
        if client is None:
            from google.cloud import firestore  # deferred heavy/optional dep

            client = firestore.Client(project=project)
        self._db = client
        self._collection = client.collection(collection or self.COLLECTION)

    def set_job_status(self, task_id: str, status_data: dict) -> None:
        data = {**status_data, "_updated_at": time.time()}
        self._collection.document(task_id).set(data)

    def get_job_status(self, task_id: str) -> Optional[dict]:
        doc = self._collection.document(task_id).get()
        return doc.to_dict() if getattr(doc, "exists", False) else None

    def update_job_status(self, task_id: str, updates: dict) -> None:
        doc_ref = self._collection.document(task_id)
        fields = {**updates, "_updated_at": time.time()}
        try:
            doc_ref.update(fields)
        except Exception:
            # Document may not exist yet — merge-create. merge=True also
            # guarantees a transient update() failure can never wipe existing
            # fields (a plain set() here would replace the whole document).
            doc_ref.set(fields, merge=True)

    def delete_job(self, task_id: str) -> None:
        self._collection.document(task_id).delete()

    def cleanup_old_jobs(self, max_age_seconds: float = 86400.0) -> int:
        cutoff = time.time() - max_age_seconds
        removed = 0
        try:
            # Keyword FieldFilter form: the positional where(field, op, value)
            # is deprecated in current google-cloud-firestore and slated for
            # removal.
            from google.cloud.firestore_v1 import FieldFilter

            query = self._collection.where(
                filter=FieldFilter("_updated_at", "<", cutoff))
        except ImportError:  # older clients (or injected test doubles)
            query = self._collection.where("_updated_at", "<", cutoff)
        for doc in query.stream():
            doc.reference.delete()
            removed += 1
        return removed
