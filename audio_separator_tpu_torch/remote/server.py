"""Remote separation API server (stdlib HTTP) over the port's ``Separator``.

The port's own copy of ``audio_separator_tpu/remote/server.py``. It differs
from it in one behaviour: :class:`SeparatorService`, :func:`serve` and
:func:`main` take ``device`` (``--device``), which every ``Separator`` the
service builds is given. ``None`` means the CUDA device and raises without
one, when the service is built; tests pass ``"cpu"``. Its root route names
the service ``audio-separator-tpu-torch``.

Serves the same HTTP surface as the reference's FastAPI deployments
(ref: remote/deploy_modal.py:539-830, deploy_cloudrun.py:404-698):

    POST /separate                multipart form: file + every separator param
    GET  /status/{task_id}        job status JSON (progress, files)
    GET  /download/{task_id}/{file_hash}
    GET  /models  /models-json    model listing
    GET  /health  /               service metadata

Jobs run asynchronously on background worker threads on this host's device;
status lives in a pluggable job store and outputs in an output store. Files
are addressed by SHA-256-prefix hashes of their names
(ref: deploy_modal.generate_file_hash:49-53).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import tempfile
import threading
import uuid
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Queue
from typing import Dict, Optional
from urllib.parse import quote, unquote

from ..separator.separator import Separator, resolve_device
from .job_store import InMemoryJobStore
from .output_store import LocalOutputStore

logger = logging.getLogger(__name__)


def check_api_key(get_header) -> bool:
    """Shared-key gate (AUDSEP_API_KEY) used by BOTH HTTP frontends (this
    stdlib server and remote/asgi.py) so the auth rules can never drift
    apart. ``get_header(name)`` must resolve a header case-insensitively
    (http.server's message object does; the ASGI adapter lowercases).
    Accepts ``X-API-Key: <key>`` or ``Authorization: Bearer <key>``; no key
    configured ⇒ open."""
    key = os.environ.get("AUDSEP_API_KEY")
    if not key:
        return True
    supplied = get_header("X-API-Key") or ""
    auth = get_header("Authorization") or ""
    if auth.startswith("Bearer "):
        supplied = supplied or auth[len("Bearer "):]
    import hmac

    return hmac.compare_digest(supplied, key)


def generate_file_hash(filename: str) -> str:
    """(ref: deploy_modal.py:49-53)."""
    return hashlib.sha256(filename.encode("utf-8")).hexdigest()[:16]


def _parse_multipart(content_type: str, body: bytes):
    """Parse multipart/form-data into (fields, files{name: (filename, bytes)})."""
    header = f"Content-Type: {content_type}\r\n\r\n".encode()
    message = BytesParser(policy=HTTP).parsebytes(header + body)
    fields: Dict[str, str] = {}
    files: Dict[str, tuple] = {}
    for part in message.iter_parts():
        disposition = part.get("Content-Disposition", "")
        name_match = re.search(r'name="([^"]*)"', disposition)
        if not name_match:
            continue
        name = name_match.group(1)
        filename_match = re.search(r'filename="([^"]*)"', disposition)
        payload = part.get_payload(decode=True) or b""
        if filename_match and filename_match.group(1):
            files[name] = (filename_match.group(1), payload)
        else:
            fields[name] = payload.decode("utf-8", errors="replace")
    return fields, files


def _to_bool(value: str) -> bool:
    return str(value).lower() in ("true", "1", "yes", "on")


def _allowed_input_buckets():
    """Buckets the server may fetch ``gcs_uri`` inputs from.

    Server-side fetches run with the service account's credentials, so an
    unrestricted ``gcs_uri`` would let any requester exfiltrate any object the
    service account can read (confused deputy). The allowlist comes from
    ``AUDSEP_GCS_INPUT_BUCKETS`` (comma-separated), falling back to the
    deployment's own ``AUDSEP_GCS_BUCKET``. Empty ⇒ gcs_uri submissions are
    refused entirely.
    """
    raw = (os.environ.get("AUDSEP_GCS_INPUT_BUCKETS")
           or os.environ.get("AUDSEP_GCS_BUCKET") or "")
    return [b.strip() for b in raw.split(",") if b.strip()]


def _fetch_gcs(gcs_uri: str):
    """Download a gs://bucket/path object → (basename, bytes). Requires
    google-cloud-storage (deferred import; clear error when absent). Only
    buckets in :func:`_allowed_input_buckets` may be read."""
    if not gcs_uri.startswith("gs://"):
        raise ValueError(f"not a gs:// URI: {gcs_uri}")
    bucket_name, _, blob_path = gcs_uri[len("gs://"):].partition("/")
    if not bucket_name or not blob_path:
        raise ValueError(f"malformed GCS URI: {gcs_uri}")
    allowed = _allowed_input_buckets()
    if bucket_name not in allowed:
        raise PermissionError(
            f"bucket {bucket_name!r} is not in the configured input allowlist "
            "(set AUDSEP_GCS_INPUT_BUCKETS or AUDSEP_GCS_BUCKET)")
    from google.cloud import storage  # optional dep

    client = storage.Client()
    data = client.bucket(bucket_name).blob(blob_path).download_as_bytes()
    return os.path.basename(blob_path), data


class SeparatorService:
    """Job queue + workers running the Separator on this host's device."""

    # Max times a coalescing scan may bounce one job back to the queue tail
    # before a worker processes it directly (see _run_worker).
    _MAX_DISPLACE = 8

    def __init__(self, work_dir: Optional[str] = None, model_file_dir: Optional[str] = None,
                 job_store=None, output_store=None, workers: Optional[int] = None,
                 device=None):
        # Checked before any worker starts: without a card, device=None
        # raises here and not in every job's status.
        self.device = str(resolve_device(device))
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="audio-separator-remote-")
        self.model_file_dir = model_file_dir
        self.jobs = job_store if job_store is not None else InMemoryJobStore()
        self.outputs = (output_store if output_store is not None
                        else LocalOutputStore(os.path.join(self.work_dir, "outputs")))
        self.uploads_dir = os.path.join(self.work_dir, "uploads")
        os.makedirs(self.uploads_dir, exist_ok=True)
        self._queue: Queue = Queue()
        # task_id -> times a coalescing scan displaced it to the queue tail.
        # Bounds reordering: under a sustained same-key stream a mismatched
        # job could otherwise be re-queued behind new arrivals forever.
        # Plain dict: per-key get/set/pop are GIL-atomic and the count is a
        # heuristic bound, so cross-worker races only shift it by ±1.
        self._displaced: dict = {}
        # Worker concurrency (AUDSEP_SERVER_WORKERS, default 1). Each job
        # builds its own Separator and model; the workers' device work shares
        # the card's default stream, and a second worker can fill the gaps a
        # job's host work (decode, encode, numpy) leaves on the card. The
        # process-wide state the jobs share is thread-safe: the float32 scope
        # (ops/precision.full_float32) counts the scopes open in every thread,
        # VR's float32 convolutions pass cuDNN's switches per call
        # (models/vr_nets.Conv2d) and the launch counters take a lock
        # (ops/_build.count). Whether workers > 1 pays on one card is not
        # measured yet; keep 1 when per-job latency matters most.
        if workers is None:
            try:
                workers = int(os.environ.get("AUDSEP_SERVER_WORKERS", "1"))
            except ValueError:
                workers = 1
        self.workers = max(1, workers)
        self._worker_threads = []
        for _ in range(self.workers):
            t = threading.Thread(target=self._run_worker, daemon=True)
            t.start()
            self._worker_threads.append(t)

    # ----------------------------------------------------------------- jobs

    def submit(self, filename: str, file_bytes: bytes, fields: Dict[str, str]) -> str:
        task_id = uuid.uuid4().hex
        upload_path = os.path.join(self.uploads_dir, f"{task_id}_{os.path.basename(filename)}")
        with open(upload_path, "wb") as f:
            f.write(file_bytes)
        self.jobs.set_job_status(task_id, {
            "task_id": task_id, "status": "queued", "progress": 0,
            "original_filename": filename, "models_used": [],
            "total_models": 1, "current_model_index": 0, "files": [],
        })
        self._queue.put((task_id, upload_path, filename, fields))
        return task_id

    def _coalesce_cap(self) -> int:
        """Cross-job batching group cap: off below 3 workers, 4 from 3
        workers on. This is the JAX package's policy, whose crossover was
        measured on its own device and not on a CUDA card; it is kept so
        that both servers coalesce alike, not because it suits the card.
        AUDSEP_SERVER_COALESCE overrides unconditionally."""
        default = 4 if self.workers >= 3 else 1
        try:
            return max(1, int(os.environ.get("AUDSEP_SERVER_COALESCE",
                                             str(default))))
        except ValueError:
            return default

    @staticmethod
    def _batch_key(fields: Dict[str, str]):
        """Jobs coalesce when everything that shapes the separation is equal.
        Presets/multi-model jobs never coalesce — their per-model loops
        dominate anyway. Jobs with custom_output_names never coalesce either:
        a group shares ONE output directory, and a custom name maps straight
        to a filename (no per-job upload-path base), so two jobs asking for
        the same custom name would silently overwrite each other's stems
        before the upload loop runs."""
        if (fields.get("preset") or fields.get("models")
                or fields.get("custom_output_names")):
            return None
        return tuple(sorted((k, v) for k, v in fields.items()))

    def _run_worker(self):
        from queue import Empty

        while True:
            group = [self._queue.get()]
            cap = self._coalesce_cap()
            key = self._batch_key(group[0][3])
            if cap > 1 and key is not None:
                # Cross-job window batching: same-settings jobs already
                # sitting in the queue share one engine pass
                # (ops/demix.demix_jobs) instead of idling the card through
                # each other's host phases. Non-matching jobs go back to
                # the tail. The scan is BOUNDED (2*cap lookahead): an
                # unbounded scan would drain the whole queue per group —
                # O(N^2) churn on heterogeneous queues, sibling workers
                # starved of work mid-scan, and unbounded reordering of
                # non-matching jobs. Displacements are COUNTED per job: a
                # mismatched job under a sustained same-key stream would
                # otherwise bounce to the tail behind new arrivals forever —
                # after _MAX_DISPLACE bounces this worker holds it and runs
                # it right after the current group instead of re-queueing.
                put_back, held = [], []
                for _ in range(2 * cap):
                    if len(group) >= cap:
                        break
                    try:
                        item = self._queue.get_nowait()
                    except Empty:
                        break
                    if self._batch_key(item[3]) == key:
                        group.append(item)
                    else:
                        bounces = self._displaced.get(item[0], 0) + 1
                        if bounces > self._MAX_DISPLACE:
                            held.append(item)
                        else:
                            self._displaced[item[0]] = bounces
                            put_back.append(item)
                for item in put_back:
                    self._queue.put(item)
                    self._queue.task_done()  # ownership returned to the queue
            else:
                held = []
            try:
                if len(group) == 1:
                    task_id, upload_path, filename, fields = group[0]
                    try:
                        self._process(task_id, upload_path, filename, fields)
                    except Exception as exc:  # job-level isolation
                        logger.exception(f"job {task_id} failed")
                        self.jobs.update_job_status(task_id, {
                            "status": "error", "error": str(exc), "progress": 0})
                else:
                    self._process_group(group)
            finally:
                for item in group:
                    self._displaced.pop(item[0], None)
                    self._queue.task_done()
            # Starvation guard: jobs whose displacement budget ran out are
            # processed by THIS worker now, individually (they didn't match
            # this group's key; running them here bounds their latency).
            for task_id, upload_path, filename, fields in held:
                self._displaced.pop(task_id, None)
                try:
                    self._process(task_id, upload_path, filename, fields)
                except Exception as exc:
                    logger.exception(f"job {task_id} failed")
                    self.jobs.update_job_status(task_id, {
                        "status": "error", "error": str(exc), "progress": 0})
                finally:
                    self._queue.task_done()

    def _process_group(self, group):
        """Run a coalesced same-settings group through Separator.separate_batch
        (one engine pass). Falls back to per-job processing on any group-level
        failure so coalescing can never make a job less reliable."""
        ids = [task_id for task_id, _, _, _ in group]
        completed: set = set()
        try:
            fields = group[0][3]
            for task_id in ids:
                self.jobs.update_job_status(
                    task_id, {"status": "processing", "progress": 10,
                              "total_models": 1, "current_model_index": 0})
            out_dir = os.path.join(self.work_dir, "group-" + ids[0])
            os.makedirs(out_dir, exist_ok=True)
            separator = self._build_separator(fields, out_dir)
            model = fields.get("model")
            separator.load_model(model) if model else separator.load_model()
            names = [json.loads(f.get("custom_output_names"))
                     if f.get("custom_output_names") else None
                     for _, _, _, f in group]
            per_job = separator.separate_batch(
                [upload_path for _, upload_path, _, _ in group], names)
            for (task_id, _, _, _), outputs in zip(group, per_job):
                files = {}
                for path in outputs:
                    full = path if os.path.isabs(path) else os.path.join(out_dir, path)
                    stored = self.outputs.upload_file(task_id, full)
                    name = os.path.basename(stored)
                    files[generate_file_hash(name)] = name
                self.jobs.update_job_status(task_id, {
                    "status": "completed", "progress": 100,
                    "models_used": [model or "default"],
                    "files": [{"hash": h, "filename": fn}
                              for h, fn in files.items()],
                })
                completed.add(task_id)
        except Exception:
            # Only the jobs NOT already marked completed are retried: a
            # late failure (e.g. upload of job 3 of 4) must not re-run —
            # or worse, regress to "error" — jobs whose results a client
            # may already have downloaded.
            pending = [j for j in group if j[0] not in completed]
            logger.exception(
                f"coalesced group {ids} failed; reprocessing "
                f"{[j[0] for j in pending]} individually "
                f"({len(completed)} already completed)")
            for task_id, upload_path, filename, fields in pending:
                try:
                    self._process(task_id, upload_path, filename, fields)
                except Exception as exc:
                    logger.exception(f"job {task_id} failed")
                    self.jobs.update_job_status(task_id, {
                        "status": "error", "error": str(exc), "progress": 0})

    def _build_separator(self, fields, out_dir):
        return Separator(
            model_file_dir=self.model_file_dir,
            output_dir=out_dir,
            output_format=fields.get("output_format", "flac"),
            output_bitrate=fields.get("output_bitrate"),
            normalization_threshold=float(fields.get("normalization_threshold", 0.9)),
            amplification_threshold=float(fields.get("amplification_threshold", 0.0)),
            output_single_stem=fields.get("output_single_stem"),
            invert_using_spec=_to_bool(fields.get("invert_using_spec", "false")),
            sample_rate=int(fields.get("sample_rate", 44100)),
            use_autocast=_to_bool(fields.get("use_autocast", "false")),
            ensemble_preset=fields.get("preset"),
            mdx_params={
                "hop_length": int(fields.get("mdx_hop_length", 1024)),
                "segment_size": int(fields.get("mdx_segment_size", 256)),
                "overlap": float(fields.get("mdx_overlap", 0.25)),
                "batch_size": int(fields.get("mdx_batch_size", 4)),
                "enable_denoise": _to_bool(fields.get("mdx_enable_denoise", "false")),
            },
            vr_params={
                "batch_size": int(fields.get("vr_batch_size", 4)),
                "window_size": int(fields.get("vr_window_size", 512)),
                "aggression": int(fields.get("vr_aggression", 5)),
                "enable_tta": _to_bool(fields.get("vr_enable_tta", "false")),
                "enable_post_process": _to_bool(fields.get("vr_enable_post_process", "false")),
                "post_process_threshold": float(fields.get("vr_post_process_threshold", 0.2)),
                "high_end_process": _to_bool(fields.get("vr_high_end_process", "false")),
            },
            demucs_params={
                "segment_size": fields.get("demucs_segment_size", "Default"),
                "shifts": int(fields.get("demucs_shifts", 2)),
                "overlap": float(fields.get("demucs_overlap", 0.25)),
                "segments_enabled": _to_bool(fields.get("demucs_segments_enabled", "true")),
            },
            mdxc_params={
                "segment_size": int(fields.get("mdxc_segment_size", 256)),
                "override_model_segment_size": _to_bool(
                    fields.get("mdxc_override_model_segment_size", "false")),
                "overlap": int(fields.get("mdxc_overlap", 8)),
                "batch_size": int(fields.get("mdxc_batch_size", 4)),
                "pitch_shift": int(fields.get("mdxc_pitch_shift", 0)),
            },
            device=self.device,
        )

    def _process(self, task_id, upload_path, filename, fields):
        self.jobs.update_job_status(task_id, {"status": "processing", "progress": 5})

        models = [None]
        if fields.get("preset"):
            models = ["__preset__"]
        elif fields.get("models"):
            models = json.loads(fields["models"])
        elif fields.get("model"):
            models = [fields["model"]]

        custom_output_names = (json.loads(fields["custom_output_names"])
                               if fields.get("custom_output_names") else None)

        out_dir = os.path.join(self.work_dir, "job-" + task_id)
        os.makedirs(out_dir, exist_ok=True)
        separator = self._build_separator(fields, out_dir)

        all_files = {}
        models_used = []
        total = len(models)
        for index, model in enumerate(models):
            self.jobs.update_job_status(task_id, {
                "status": "processing",
                "progress": 10 + int(80 * index / total),
                "current_model_index": index,
                "total_models": total,
            })
            if model == "__preset__" or model is None:
                separator.load_model()
            else:
                separator.load_model(model)
            models_used.append(model or "default")
            outputs = separator.separate(upload_path, custom_output_names)
            for path in outputs:
                full = path if os.path.isabs(path) else os.path.join(out_dir, path)
                stored = self.outputs.upload_file(task_id, full)
                name = os.path.basename(stored)
                all_files[generate_file_hash(name)] = name

        self.jobs.update_job_status(task_id, {
            "status": "completed", "progress": 100,
            "models_used": models_used,
            "files": [{"hash": h, "filename": fn} for h, fn in all_files.items()],
        })

    # ------------------------------------------------------------- retrieval

    def get_status(self, task_id: str) -> Optional[dict]:
        data = self.jobs.get_job_status(task_id)
        if data:
            data.pop("_updated_at", None)
        return data

    def get_file_by_hash(self, task_id: str, file_hash: str):
        for name in self.outputs.list_files(task_id):
            if generate_file_hash(name) == file_hash:
                return self.outputs.download_file(task_id, name), name
        raise FileNotFoundError(file_hash)

    def wait(self, task_id: str, timeout: Optional[float] = None,
             poll_interval: float = 1.0) -> Optional[dict]:
        """Block until ``task_id`` reaches a terminal status and return it.

        For callers whose execution model requires the work to finish inside
        the call (e.g. a Modal function invocation — the container may be
        reclaimed the moment the call returns, killing the queue worker
        mid-job). Returns the last observed status on timeout."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            status = self.get_status(task_id)
            if status is not None and status.get("status") in (
                    "completed", "error", "not_found"):
                return status
            if deadline is not None and _time.monotonic() >= deadline:
                return status
            _time.sleep(poll_interval)


def make_handler(service: SeparatorService):
    from .. import __version__

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.debug("%s - %s", self.address_string(), fmt % args)

        # ------------------------------------------------------------ helpers

        def _json(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, status, detail):
            self._json({"detail": detail}, status=status)

        def _authorized(self) -> bool:
            """Optional shared-key gate (AUDSEP_API_KEY). When set, job
            submission/status/download require ``X-API-Key: <key>`` or
            ``Authorization: Bearer <key>``; listing/health stay open."""
            return check_api_key(self.headers.get)

        # ------------------------------------------------------------- routes

        def do_GET(self):
            path = unquote(self.path.split("?")[0])
            if path in ("/", ""):
                self._json({
                    "service": "audio-separator-tpu-torch",
                    "version": __version__,
                    "endpoints": ["/separate", "/status/{task_id}",
                                  "/download/{task_id}/{file_hash}", "/models",
                                  "/models-json", "/presets", "/health"],
                })
            elif path == "/health":
                self._json({"status": "healthy", "version": __version__})
            elif path == "/models-json":
                separator = Separator(info_only=True,
                                      model_file_dir=service.model_file_dir)
                self._json(separator.list_supported_model_files())
            elif path == "/models":
                separator = Separator(info_only=True,
                                      model_file_dir=service.model_file_dir)
                self._json(separator.get_simplified_model_list())
            elif path == "/presets":
                from .asgi import _load_presets

                self._json(_load_presets())
            elif path.startswith("/status/"):
                if not self._authorized():
                    self._error(401, "invalid or missing API key")
                    return
                task_id = path[len("/status/"):]
                data = service.get_status(task_id)
                if data is None:
                    self._error(404, "Job not found")
                else:
                    self._json(data)
            elif path.startswith("/download/"):
                if not self._authorized():
                    self._error(401, "invalid or missing API key")
                    return
                parts = path[len("/download/"):].split("/")
                if len(parts) != 2:
                    self._error(404, "File not found")
                    return
                try:
                    data, name = service.get_file_by_hash(parts[0], parts[1])
                except FileNotFoundError:
                    self._error(404, "File not found")
                    return
                ascii_name = "".join(c if ord(c) < 128 else "_" for c in name)
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header(
                    "Content-Disposition",
                    f"attachment; filename=\"{ascii_name}\"; "
                    f"filename*=UTF-8''{quote(name, safe='')}")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._error(404, "Not found")

        def do_POST(self):
            path = unquote(self.path.split("?")[0])
            if path != "/separate":
                self._error(404, "Not found")
                return
            if not self._authorized():
                self._error(401, "invalid or missing API key")
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            content_type = self.headers.get("Content-Type", "")
            if "multipart/form-data" not in content_type:
                self._error(400, "multipart/form-data required")
                return
            try:
                fields, files = _parse_multipart(content_type, body)
            except Exception as exc:
                self._error(400, f"invalid multipart body: {exc}")
                return
            upload = files.get("file")
            if not upload or not upload[0]:
                gcs_uri = fields.get("gcs_uri")
                if gcs_uri:
                    # GCS-input submissions (ref: deploy_cloudrun.py:404-560
                    # gcs_uri option): fetch the object server-side.
                    try:
                        filename, file_bytes = _fetch_gcs(gcs_uri)
                    except PermissionError as exc:
                        self._error(403, str(exc))
                        return
                    except Exception as exc:
                        self._error(400, f"could not fetch {gcs_uri}: {exc}")
                        return
                    task_id = service.submit(filename, file_bytes, fields)
                    self._json({"task_id": task_id, "status": "queued"})
                    return
                self._error(400, "No audio file provided")
                return
            filename, file_bytes = upload
            task_id = service.submit(filename, file_bytes, fields)
            self._json({"task_id": task_id, "status": "queued"})

    return Handler


def _stores_from_env(work_dir: str):
    """Cloud-deployment store wiring via env (ref: deploy_cloudrun.py's
    Firestore/GCS setup, deploy_modal.py's volume-backed stores):

      AUDSEP_JOB_STORE    = memory (default) | file | firestore
      AUDSEP_OUTPUT_STORE = local (default) | gcs
      AUDSEP_GCS_BUCKET / AUDSEP_GCP_PROJECT — for the cloud backends
    """
    from .job_store import FileJobStore, FirestoreJobStore
    from .output_store import GCSOutputStore

    project = os.environ.get("AUDSEP_GCP_PROJECT") or None
    kind = os.environ.get("AUDSEP_JOB_STORE", "memory")
    if kind == "file":
        jobs = FileJobStore(os.path.join(work_dir, "jobs"))
    elif kind == "firestore":
        jobs = FirestoreJobStore(project=project)
    else:
        jobs = InMemoryJobStore()
    if os.environ.get("AUDSEP_OUTPUT_STORE", "local") == "gcs":
        outputs = GCSOutputStore(
            bucket_name=os.environ.get("AUDSEP_GCS_BUCKET"), project=project)
    else:
        outputs = LocalOutputStore(os.path.join(work_dir, "outputs"))
    return jobs, outputs


def serve(host: str = "0.0.0.0", port: int = 8000,
          model_file_dir: Optional[str] = None,
          work_dir: Optional[str] = None,
          workers: Optional[int] = None,
          device=None) -> ThreadingHTTPServer:
    """A ``ThreadingHTTPServer`` over a new :class:`SeparatorService` (its
    ``service`` attribute); the caller runs ``serve_forever``. ``device``
    ``None`` means the CUDA device and raises without one."""
    work_dir = work_dir or tempfile.mkdtemp(prefix="audio-separator-remote-")
    jobs, outputs = _stores_from_env(work_dir)
    service = SeparatorService(work_dir=work_dir, model_file_dir=model_file_dir,
                               job_store=jobs, output_store=outputs,
                               workers=workers, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.service = service  # type: ignore[attr-defined]
    return server


def main():
    import argparse

    parser = argparse.ArgumentParser(description="audio-separator remote API server")
    parser.add_argument("--host", default="0.0.0.0")
    # PORT env fallback follows the Cloud Run convention
    # (ref: deploy_cloudrun.py service entry).
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("PORT", 8000)))
    parser.add_argument("--model_file_dir", default=None)
    parser.add_argument("--work_dir", default=None)
    parser.add_argument("--workers", type=int, default=None,
                        help="concurrent job workers (default: "
                             "AUDSEP_SERVER_WORKERS or 1)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu; the CUDA device must exist")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    server = serve(args.host, args.port, args.model_file_dir, args.work_dir,
                   workers=args.workers, device=args.device)
    logger.info(f"Serving on {args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
