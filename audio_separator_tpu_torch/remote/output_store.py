"""Output-file stores for the remote API.

The port's own copy of ``audio_separator_tpu/remote/output_store.py``.

The reference uploads task outputs to GCS (ref: remote/output_store.py:11-58);
here a local-directory store provides the same interface for single-host or
shared-volume deployments.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional


class LocalOutputStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _task_dir(self, task_id: str) -> str:
        safe = "".join(c for c in task_id if c.isalnum() or c in "-_")
        return os.path.join(self.root, safe)

    def upload_file(self, task_id: str, local_path: str) -> str:
        task_dir = self._task_dir(task_id)
        os.makedirs(task_dir, exist_ok=True)
        dest = os.path.join(task_dir, os.path.basename(local_path))
        if os.path.abspath(local_path) != os.path.abspath(dest):
            shutil.copy2(local_path, dest)
        return dest

    def download_file(self, task_id: str, filename: str) -> bytes:
        path = os.path.join(self._task_dir(task_id), filename)
        with open(path, "rb") as f:
            return f.read()

    def list_files(self, task_id: str) -> List[str]:
        task_dir = self._task_dir(task_id)
        if not os.path.isdir(task_dir):
            return []
        return sorted(os.listdir(task_dir))

    def delete_task_outputs(self, task_id: str) -> None:
        shutil.rmtree(self._task_dir(task_id), ignore_errors=True)


class GCSOutputStore:
    """GCS-backed outputs so any serving instance can serve downloads
    (ref: remote/output_store.py:11-58), adapted to this package's store
    interface. Requires ``google-cloud-storage`` unless a ``bucket`` is
    injected (tests / emulators)."""

    def __init__(self, bucket_name: Optional[str] = None,
                 project: Optional[str] = None, bucket=None):
        if bucket is None:
            from google.cloud import storage  # deferred heavy/optional dep

            client = storage.Client(project=project)
            bucket = client.bucket(bucket_name)
        self._bucket = bucket

    def upload_file(self, task_id: str, local_path: str) -> str:
        gcs_path = f"{task_id}/{os.path.basename(local_path)}"
        self._bucket.blob(gcs_path).upload_from_filename(local_path)
        return gcs_path

    def download_file(self, task_id: str, filename: str) -> bytes:
        return self._bucket.blob(f"{task_id}/{filename}").download_as_bytes()

    def list_files(self, task_id: str) -> List[str]:
        names = [b.name.split("/", 1)[1]
                 for b in self._bucket.list_blobs(prefix=f"{task_id}/")]
        return sorted(names)

    def delete_task_outputs(self, task_id: str) -> None:
        for blob in list(self._bucket.list_blobs(prefix=f"{task_id}/")):
            blob.delete()
