"""The port's remote service (``audio_separator_tpu_torch/remote``) on the
CPU: the cases of ``tests/test_remote.py`` and the ASGI cases of
``tests/test_deploy.py`` against the port with ``device="cpu"``; a route
contract (one sequence of requests to the JAX server and to the port's gives
the same status codes and JSON keys); and one real separation over HTTP,
whose stems equal the port's direct ``separate`` and are >= 40 dB against
the JAX server's stems for the same upload (tests/test_parity_pipeline.py's
bar).

Every model directory holds an empty ``download_checks.json``, so the
registries list and resolve models without the network."""

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from audio_separator_tpu_torch.io import audio as audio_io
from audio_separator_tpu_torch.remote import server as server_mod
from audio_separator_tpu_torch.remote.api_client import AudioSeparatorAPIClient
from audio_separator_tpu_torch.remote.asgi import create_app
from audio_separator_tpu_torch.remote.job_store import (FileJobStore, FirestoreJobStore,
                                                        InMemoryJobStore)
from audio_separator_tpu_torch.remote.output_store import GCSOutputStore, LocalOutputStore
from audio_separator_tpu_torch.remote.server import (SeparatorService, generate_file_hash,
                                                     serve)
from audio_separator_tpu_torch.separator.separator import Separator

from test_deploy import asgi_request, multipart_body
from torch_threads import one_torch_thread  # noqa: F401

SR = 44100
WAIT_S = 60


@pytest.fixture()
def model_dir(tmp_path):
    path = tmp_path / "models"
    path.mkdir()
    (path / "download_checks.json").write_text("{}")
    return str(path)


def _service(tmp_path, name="work", **kwargs):
    """A CPU service with its own work and model directories."""
    models = tmp_path / "service-models"
    models.mkdir(exist_ok=True)
    (models / "download_checks.json").write_text("{}")
    return SeparatorService(work_dir=str(tmp_path / name), model_file_dir=str(models),
                            device="cpu", **kwargs)


def _running(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture()
def http_server(tmp_path, model_dir):
    server = serve(host="127.0.0.1", port=0, work_dir=str(tmp_path / "work"),
                   model_file_dir=model_dir, device="cpu")
    yield server, _running(server)
    server.shutdown()
    server.server_close()


def _song(path, seconds=1.0, seed=0):
    n = int(SR * seconds)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    mix = (0.3 * np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 330 * t)])
           + 0.02 * rng.standard_normal((2, n))).astype(np.float32)
    audio_io.save_audio(str(path), mix, SR)
    return str(path)


def _fake_load_model(self, model_filename="default"):
    self.model_filename = str(model_filename)
    self.model_filenames = [self.model_filename]
    self.model_instance = object()


def _emit(self, path):
    base = os.path.splitext(os.path.basename(path))[0]
    out = os.path.join(self.output_dir, f"{base}_(Vocals)_fake.wav")
    with open(out, "wb") as f:
        f.write(b"RIFF" + b"\0" * 16)
    return out


def _http(method, url, body=None, headers=None):
    """(status, parsed JSON or raw bytes) over the standard library."""
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            status, payload, ctype = resp.status, resp.read(), resp.headers["Content-Type"]
    except urllib.error.HTTPError as exc:
        status, payload, ctype = exc.code, exc.read(), exc.headers["Content-Type"]
    return status, (json.loads(payload) if ctype == "application/json" else payload)


# ---------------------------------------------------------------------------
# Stores and hashes


def test_job_store_roundtrip(tmp_path):
    for store in (InMemoryJobStore(), FileJobStore(str(tmp_path / "jobs"))):
        store.set_job_status("abc", {"status": "queued", "progress": 0})
        store.update_job_status("abc", {"progress": 50})
        data = store.get_job_status("abc")
        assert data["progress"] == 50 and data["status"] == "queued"
        store.delete_job("abc")
        assert store.get_job_status("abc") is None


def test_output_store_roundtrip(tmp_path):
    store = LocalOutputStore(str(tmp_path / "outputs"))
    src = tmp_path / "a.txt"
    src.write_bytes(b"hello")
    store.upload_file("task1", str(src))
    assert store.list_files("task1") == ["a.txt"]
    assert store.download_file("task1", "a.txt") == b"hello"
    store.delete_task_outputs("task1")
    assert store.list_files("task1") == []


def test_file_hash_stable():
    from audio_separator_tpu.remote.server import generate_file_hash as jax_hash

    assert generate_file_hash("a.flac") == generate_file_hash("a.flac") == jax_hash("a.flac")
    assert len(generate_file_hash("a.flac")) == 16


def test_firestore_job_store_with_fake_client():
    docs = {}

    class FakeDoc:
        def __init__(self, key):
            self.key = key
            self.reference = self

        @property
        def exists(self):
            return self.key in docs

        def to_dict(self):
            return dict(docs[self.key])

        def get(self):
            return self

        def set(self, data, merge=False):
            if merge and self.key in docs:
                docs[self.key].update(data)
            else:
                docs[self.key] = dict(data)

        def update(self, fields):
            if self.key not in docs:
                raise KeyError(self.key)
            docs[self.key].update(fields)

        def delete(self):
            docs.pop(self.key, None)

    class FakeCollection:
        def document(self, task_id):
            return FakeDoc(task_id)

        def where(self, field, op, value):
            assert (field, op) == ("_updated_at", "<")
            hits = [FakeDoc(k) for k, v in list(docs.items())
                    if v.get("_updated_at", 0) < value]

            class Q:
                def stream(self_q):
                    return iter(hits)

            return Q()

    class FakeClient:
        def collection(self, name):
            return FakeCollection()

    store = FirestoreJobStore(client=FakeClient())
    store.set_job_status("t1", {"status": "processing", "progress": 10})
    assert store.get_job_status("t1")["progress"] == 10
    store.update_job_status("t1", {"progress": 80})
    assert store.get_job_status("t1")["progress"] == 80
    store.update_job_status("t2", {"status": "queued"})  # create-on-update
    assert store.get_job_status("t2")["status"] == "queued"
    docs["t1"]["_updated_at"] = time.time() - 99999
    assert store.cleanup_old_jobs(3600) == 1
    assert store.get_job_status("t1") is None
    store.delete_job("t2")
    assert store.get_job_status("t2") is None


def test_gcs_output_store_with_fake_bucket(tmp_path):
    blobs = {}

    class FakeBlob:
        def __init__(self, name):
            self.name = name

        def upload_from_filename(self, path):
            with open(path, "rb") as f:
                blobs[self.name] = f.read()

        def download_as_bytes(self):
            return blobs[self.name]

        def delete(self):
            blobs.pop(self.name, None)

    class FakeBucket:
        def blob(self, name):
            return FakeBlob(name)

        def list_blobs(self, prefix=""):
            return [FakeBlob(n) for n in sorted(blobs) if n.startswith(prefix)]

    store = GCSOutputStore(bucket=FakeBucket())
    src = tmp_path / "vocals.wav"
    src.write_bytes(b"RIFFdata")
    assert store.upload_file("task9", str(src)) == "task9/vocals.wav"
    assert store.list_files("task9") == ["vocals.wav"]
    assert store.download_file("task9", "vocals.wav") == b"RIFFdata"
    store.delete_task_outputs("task9")
    assert store.list_files("task9") == []


def test_server_store_wiring_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("AUDSEP_JOB_STORE", "file")
    monkeypatch.delenv("AUDSEP_OUTPUT_STORE", raising=False)
    jobs, outputs = server_mod._stores_from_env(str(tmp_path))
    assert isinstance(jobs, FileJobStore)
    assert isinstance(outputs, LocalOutputStore)
    jobs.set_job_status("t", {"status": "queued"})
    assert jobs.get_job_status("t")["status"] == "queued"


# ---------------------------------------------------------------------------
# Device


def test_service_without_cuda_raises(tmp_path):
    """``device=None`` means the CUDA device, for the service as for
    ``Separator``: without a card it raises before any worker starts."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for make in (lambda: SeparatorService(work_dir=str(tmp_path / "a")),
                 lambda: SeparatorService(work_dir=str(tmp_path / "b"), device="cuda"),
                 lambda: serve(host="127.0.0.1", port=0, work_dir=str(tmp_path / "c"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_app(work_dir=str(tmp_path / "d")).service


def test_service_passes_its_device_to_every_separator(tmp_path):
    service = _service(tmp_path, "work", workers=1)
    assert service.device == "cpu"
    sep = service._build_separator({"output_format": "wav"}, str(tmp_path / "out"))
    assert sep.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# HTTP server with a stand-in separation


def test_health_models_and_job_flow(http_server, tmp_path, monkeypatch):
    server, url = http_server
    client = AudioSeparatorAPIClient(url)
    assert client.get_server_version() != ""
    assert "MDXC" in client.list_models(format_type="json")

    def fake_separate(self, audio_file_path, custom_output_names=None):
        pcm, sr = audio_io.load_audio(audio_file_path, sample_rate=SR)
        out = os.path.join(self.output_dir, "out_(Vocals)_fake.wav")
        audio_io.save_audio(out, pcm[:, : sr // 2], sr)
        return [out]

    monkeypatch.setattr(Separator, "load_model", _fake_load_model)
    monkeypatch.setattr(Separator, "separate", fake_separate)

    result = client.separate_audio(file_path=_song(tmp_path / "song.wav"),
                                   model="whatever.ckpt", output_format="wav")
    task_id = result["task_id"]
    assert result["status"] == "queued"
    status = server.service.wait(task_id, timeout=WAIT_S, poll_interval=0.05)
    assert status["status"] == "completed", status
    assert status == client.get_job_status(task_id)
    assert len(status["files"]) == 1
    entry = status["files"][0]
    out = client.download_file_by_hash(task_id, entry["hash"], entry["filename"],
                                       str(tmp_path / "dl"))
    assert os.path.getsize(out) > 1000
    assert _http("GET", f"{url}/status/nope")[0] == 404


def test_service_concurrent_workers(tmp_path, monkeypatch):
    windows = []
    lock = threading.Lock()

    def fake_separate(self, audio_file_path, custom_output_names=None):
        t0 = time.time()
        time.sleep(0.5)
        out = _emit(self, audio_file_path)
        with lock:
            windows.append((t0, time.time()))
        return [out]

    monkeypatch.setattr(Separator, "load_model", _fake_load_model)
    monkeypatch.setattr(Separator, "separate", fake_separate)
    monkeypatch.setenv("AUDSEP_SERVER_COALESCE", "1")

    service = _service(tmp_path, "work", workers=2)
    assert service.workers == 2
    ids = [service.submit(f"t{i}.wav", b"x", {"model": "m.ckpt"}) for i in range(4)]
    for tid in ids:
        st = service.wait(tid, timeout=WAIT_S, poll_interval=0.05)
        assert st and st["status"] == "completed", st
    assert any(a0 < b1 and b0 < a1 for i, (a0, a1) in enumerate(windows)
               for (b0, b1) in windows[i + 1:]), windows


def test_service_workers_env_default(tmp_path, monkeypatch):
    monkeypatch.setenv("AUDSEP_SERVER_WORKERS", "3")
    assert _service(tmp_path).workers == 3


def test_gcs_uri_submission(monkeypatch, tmp_path, model_dir):
    monkeypatch.setattr(server_mod, "_fetch_gcs", lambda uri: ("song.wav", b"RIFFfake"))
    srv = serve(host="127.0.0.1", port=0, work_dir=str(tmp_path), model_file_dir=model_dir,
                device="cpu")
    url = _running(srv)
    try:
        body, ctype = multipart_body({"gcs_uri": "gs://bucket/song.wav"})
        status, payload = _http("POST", f"{url}/separate", body, {"Content-Type": ctype})
        assert status == 200 and payload["status"] == "queued" and payload["task_id"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_gcs_uri_bucket_allowlist(monkeypatch):
    monkeypatch.delenv("AUDSEP_GCS_INPUT_BUCKETS", raising=False)
    monkeypatch.delenv("AUDSEP_GCS_BUCKET", raising=False)
    with pytest.raises(PermissionError):
        server_mod._fetch_gcs("gs://victim-bucket/secret.wav")
    monkeypatch.setenv("AUDSEP_GCS_INPUT_BUCKETS", "uploads-a, uploads-b")
    with pytest.raises(PermissionError):
        server_mod._fetch_gcs("gs://victim-bucket/secret.wav")
    assert server_mod._allowed_input_buckets() == ["uploads-a", "uploads-b"]
    monkeypatch.delenv("AUDSEP_GCS_INPUT_BUCKETS", raising=False)
    monkeypatch.setenv("AUDSEP_GCS_BUCKET", "deploy-bucket")
    assert server_mod._allowed_input_buckets() == ["deploy-bucket"]
    with pytest.raises(ValueError):
        server_mod._fetch_gcs("http://deploy-bucket/x.wav")


def test_gcs_uri_submission_rejected_outside_allowlist(monkeypatch, http_server):
    monkeypatch.delenv("AUDSEP_GCS_INPUT_BUCKETS", raising=False)
    monkeypatch.delenv("AUDSEP_GCS_BUCKET", raising=False)
    _, url = http_server
    body, ctype = multipart_body({"gcs_uri": "gs://victim/secret.wav"})
    assert _http("POST", f"{url}/separate", body, {"Content-Type": ctype})[0] == 403


def test_api_key_gate(monkeypatch, http_server):
    monkeypatch.setenv("AUDSEP_API_KEY", "sekrit")
    _, url = http_server
    assert _http("GET", f"{url}/health")[0] == 200
    assert _http("GET", f"{url}/status/nope")[0] == 401
    for headers in ({"X-API-Key": "sekrit"}, {"Authorization": "Bearer sekrit"}):
        assert _http("GET", f"{url}/status/nope", headers=headers)[0] == 404
    body, ctype = multipart_body({"model": "x"})
    assert _http("POST", f"{url}/separate", body, {"Content-Type": ctype})[0] == 401
    assert _http("GET", f"{url}/download/a/b", headers={"X-API-Key": "wrong"})[0] == 401


# ---------------------------------------------------------------------------
# Coalescing


def test_service_coalesces_jobs(tmp_path, monkeypatch):
    groups, started = [], threading.Event()

    def fake_separate_batch(self, paths, names=None):
        started.wait(5)
        groups.append(list(paths))
        return [[_emit(self, p)] for p in paths]

    def fake_separate(self, audio_file_path, custom_output_names=None):
        started.wait(5)
        return [_emit(self, audio_file_path)]

    monkeypatch.setattr(Separator, "load_model", _fake_load_model)
    monkeypatch.setattr(Separator, "separate_batch", fake_separate_batch)
    monkeypatch.setattr(Separator, "separate", fake_separate)
    monkeypatch.setenv("AUDSEP_SERVER_COALESCE", "4")

    service = _service(tmp_path, "work", workers=1)
    same = {"model": "m.ckpt", "output_format": "wav"}
    ids = [service.submit(f"t{i}.wav", b"x", dict(same)) for i in range(3)]
    other = service.submit("o.wav", b"x", {"model": "n.ckpt", "output_format": "wav"})
    started.set()
    for tid in ids + [other]:
        st = service.wait(tid, timeout=WAIT_S, poll_interval=0.05)
        assert st and st["status"] == "completed", st
        assert len(st["files"]) == 1
    batched = [g for g in groups if len(g) > 1]
    assert batched and len(batched[0]) >= 2
    assert all("o.wav" not in os.path.basename(p) for g in batched for p in g)


def test_coalesce_default_follows_worker_count(tmp_path, monkeypatch):
    monkeypatch.delenv("AUDSEP_SERVER_COALESCE", raising=False)
    monkeypatch.delenv("AUDSEP_SERVER_WORKERS", raising=False)
    svc1 = _service(tmp_path, "w1", workers=1)
    svc3 = _service(tmp_path, "w3", workers=3)
    assert svc1._coalesce_cap() == 1
    assert svc3._coalesce_cap() == 4
    monkeypatch.setenv("AUDSEP_SERVER_COALESCE", "2")
    assert svc1._coalesce_cap() == 2
    assert svc3._coalesce_cap() == 2


def test_custom_output_names_never_coalesce():
    base = {"model": "m.ckpt", "output_format": "wav"}
    with_names = dict(base, custom_output_names='{"Vocals": "vocals"}')
    assert SeparatorService._batch_key(base) is not None
    assert SeparatorService._batch_key(with_names) is None
    assert SeparatorService._batch_key(dict(base, preset="karaoke")) is None


def test_displaced_job_runs_via_starvation_guard(tmp_path, monkeypatch):
    solo, started = [], threading.Event()

    def fake_separate_batch(self, paths, names=None):
        started.wait(5)
        return [[_emit(self, p)] for p in paths]

    def fake_separate(self, audio_file_path, custom_output_names=None):
        started.wait(5)
        solo.append(os.path.basename(audio_file_path))
        return [_emit(self, audio_file_path)]

    monkeypatch.setattr(Separator, "load_model", _fake_load_model)
    monkeypatch.setattr(Separator, "separate_batch", fake_separate_batch)
    monkeypatch.setattr(Separator, "separate", fake_separate)
    monkeypatch.setenv("AUDSEP_SERVER_COALESCE", "4")
    monkeypatch.setattr(SeparatorService, "_MAX_DISPLACE", 0)

    service = _service(tmp_path, "work", workers=1)
    same = {"model": "m.ckpt", "output_format": "wav"}
    a1 = service.submit("a1.wav", b"x", dict(same))
    b = service.submit("b.wav", b"x", {"model": "n.ckpt", "output_format": "wav"})
    rest = [service.submit(f"a{i}.wav", b"x", dict(same)) for i in (2, 3)]
    started.set()
    for tid in [a1, b] + rest:
        st = service.wait(tid, timeout=WAIT_S, poll_interval=0.05)
        assert st and st["status"] == "completed", st
    assert any(p.endswith("_b.wav") for p in solo), solo
    assert not service._displaced


def test_group_failure_retries_only_incomplete_jobs(tmp_path, monkeypatch, caplog):
    """A late group failure (upload of job 2 dies) re-runs only the jobs not
    completed yet, and the server logs the coalesced group's failure."""
    solo, started = [], threading.Event()

    def fake_separate_batch(self, paths, names=None):
        started.wait(5)
        return [[_emit(self, p)] for p in paths]

    def fake_separate(self, audio_file_path, custom_output_names=None):
        started.wait(5)
        solo.append(os.path.basename(audio_file_path))
        return [_emit(self, audio_file_path)]

    monkeypatch.setattr(Separator, "load_model", _fake_load_model)
    monkeypatch.setattr(Separator, "separate_batch", fake_separate_batch)
    monkeypatch.setattr(Separator, "separate", fake_separate)
    monkeypatch.setenv("AUDSEP_SERVER_COALESCE", "4")

    service = _service(tmp_path, "work", workers=1)
    real_upload = service.outputs.upload_file
    failed_once = []

    def flaky_upload(task_id, path):
        if "second" in path and not failed_once:
            failed_once.append(task_id)
            raise OSError("disk full")
        return real_upload(task_id, path)

    monkeypatch.setattr(service.outputs, "upload_file", flaky_upload)
    caplog.set_level(logging.ERROR, logger=server_mod.logger.name)
    blocker = service.submit("blocker.wav", b"x", {"model": "z.ckpt", "output_format": "wav"})
    same = {"model": "m.ckpt", "output_format": "wav"}
    first = service.submit("first.wav", b"x", dict(same))
    second = service.submit("second.wav", b"x", dict(same))
    started.set()
    assert service.wait(blocker, timeout=WAIT_S, poll_interval=0.05)["status"] == "completed"
    for tid in (first, second):
        st = service.wait(tid, timeout=WAIT_S, poll_interval=0.05)
        assert st and st["status"] == "completed", st
    assert failed_once, "jobs never coalesced — blocker setup broken"
    retried = [p for p in solo if not p.endswith("_blocker.wav")]
    assert len(retried) == 1 and retried[0].endswith("_second.wav"), solo
    assert any(r.getMessage().startswith("coalesced group") for r in caplog.records)


def test_separator_service_wait_reaches_terminal_status():
    svc = SeparatorService.__new__(SeparatorService)  # no worker thread
    states = iter([{"status": "queued"}, {"status": "processing"},
                   {"status": "completed", "files": []}])
    svc.get_status = lambda task_id: next(states)
    assert svc.wait("t", poll_interval=0.0)["status"] == "completed"
    svc.get_status = lambda task_id: {"status": "processing"}
    assert svc.wait("t", timeout=0.05, poll_interval=0.01)["status"] == "processing"


# ---------------------------------------------------------------------------
# ASGI


def test_asgi_info_health_models_presets(tmp_path, model_dir):
    app = create_app(work_dir=str(tmp_path / "work"), model_file_dir=model_dir, device="cpu")
    status, body = asgi_request(app, "GET", "/")
    assert status == 200 and "/presets" in json.loads(body)["endpoints"]
    status, body = asgi_request(app, "GET", "/health")
    assert status == 200 and json.loads(body)["status"] == "healthy"
    status, body = asgi_request(app, "GET", "/models-json")
    assert status == 200 and "MDXC" in json.loads(body)
    status, body = asgi_request(app, "GET", "/presets")
    with open(os.path.join(os.path.dirname(server_mod.__file__), "..", "data",
                           "ensemble_presets.json"), encoding="utf-8") as f:
        assert status == 200 and json.loads(body) == json.load(f)
    assert asgi_request(app, "GET", "/nope")[0] == 404
    assert asgi_request(app, "GET", "/status/unknown-task")[0] == 404


def test_asgi_separate_job_flow(tmp_path, monkeypatch, model_dir):
    def fake_separate(self, audio_file_path, custom_output_names=None):
        pcm, sr = audio_io.load_audio(audio_file_path, sample_rate=SR)
        out = os.path.join(self.output_dir, "out_(Vocals)_fake.wav")
        audio_io.save_audio(out, pcm[:, : sr // 2], sr)
        return [out]

    monkeypatch.setattr(Separator, "load_model", _fake_load_model)
    monkeypatch.setattr(Separator, "separate", fake_separate)

    app = create_app(work_dir=str(tmp_path / "work"), model_file_dir=model_dir, device="cpu")
    with open(_song(tmp_path / "song.wav"), "rb") as f:
        audio_bytes = f.read()
    body, ctype = multipart_body({"model": "whatever.ckpt", "output_format": "wav"},
                                 ("song.wav", audio_bytes))
    status, payload = asgi_request(app, "POST", "/separate", {"Content-Type": ctype}, body)
    assert status == 200, payload
    task_id = json.loads(payload)["task_id"]
    data = app.service.wait(task_id, timeout=WAIT_S, poll_interval=0.05)
    assert data["status"] == "completed", data
    status, payload = asgi_request(app, "GET", f"/status/{task_id}")
    assert status == 200 and json.loads(payload) == data
    entry = data["files"][0]
    status, blob = asgi_request(app, "GET", f"/download/{task_id}/{entry['hash']}")
    assert status == 200 and len(blob) > 1000
    assert asgi_request(app, "GET", f"/download/{task_id}/deadbeef")[0] == 404
    assert asgi_request(app, "POST", "/separate", {"Content-Type": "application/json"},
                        b"{}")[0] == 400
    body2, ctype2 = multipart_body({"model": "m.ckpt"})
    assert asgi_request(app, "POST", "/separate", {"Content-Type": ctype2}, body2)[0] == 400


def test_asgi_api_key_gate(tmp_path, monkeypatch, model_dir):
    monkeypatch.setenv("AUDSEP_API_KEY", "sekrit")
    app = create_app(work_dir=str(tmp_path / "work"), model_file_dir=model_dir, device="cpu")
    assert asgi_request(app, "GET", "/status/x")[0] == 401
    assert asgi_request(app, "GET", "/status/x", {"Authorization": "Bearer sekrit"})[0] == 404
    assert asgi_request(app, "GET", "/health")[0] == 200


# ---------------------------------------------------------------------------
# Route contract: the JAX server and the port's answer one sequence of
# requests with the same status codes and JSON keys.


def _route_sequence(url, song_bytes):
    """[(request, status, sorted JSON keys or the body's type)] for one run
    through every route, ending with a completed job and its download."""
    seen = []

    def record(name, method, path, body=None, headers=None):
        status, payload = _http(method, url + path, body, headers)
        shape = sorted(payload) if isinstance(payload, dict) else type(payload).__name__
        seen.append((name, status, shape))
        return status, payload

    for path in ("/", "/health", "/models-json", "/models", "/presets", "/status/nope",
                 "/download/a/b", "/download/a", "/nope"):
        record("GET " + path, "GET", path)
    record("POST json", "POST", "/separate", b"{}", {"Content-Type": "application/json"})
    body, ctype = multipart_body({"model": "m.ckpt"})
    record("POST no file", "POST", "/separate", body, {"Content-Type": ctype})
    record("POST /nope", "POST", "/nope", body, {"Content-Type": ctype})
    body, ctype = multipart_body({"model": "m.ckpt", "output_format": "wav"},
                                 ("song.wav", song_bytes))
    _, submitted = record("POST file", "POST", "/separate", body, {"Content-Type": ctype})
    task_id = submitted["task_id"]
    deadline = time.monotonic() + WAIT_S
    while _http("GET", f"{url}/status/{task_id}")[1]["status"] not in ("completed", "error"):
        assert time.monotonic() < deadline, "job did not finish"
        time.sleep(0.05)
    _, status = record("GET status", "GET", f"/status/{task_id}")
    assert status["status"] == "completed", status
    record("GET download", "GET", f"/download/{task_id}/{status['files'][0]['hash']}")
    record("GET download other task", "GET", f"/download/nope/{status['files'][0]['hash']}")
    return seen


def test_route_contract_matches_jax_server(tmp_path, monkeypatch, model_dir):
    from audio_separator_tpu.remote import server as jax_server
    from audio_separator_tpu.separator.separator import Separator as JaxSeparator

    def fake_separate(self, audio_file_path, custom_output_names=None):
        return [_emit(self, audio_file_path)]

    for cls in (Separator, JaxSeparator):
        monkeypatch.setattr(cls, "load_model", _fake_load_model)
        monkeypatch.setattr(cls, "separate", fake_separate)
    with open(_song(tmp_path / "song.wav"), "rb") as f:
        song_bytes = f.read()

    sequences = {}
    for name, make in (("jax", lambda: jax_server.serve(
                            host="127.0.0.1", port=0, work_dir=str(tmp_path / "jax"),
                            model_file_dir=model_dir, workers=1)),
                       ("port", lambda: serve(
                            host="127.0.0.1", port=0, work_dir=str(tmp_path / "port"),
                            model_file_dir=model_dir, workers=1, device="cpu"))):
        srv = make()
        url = _running(srv)
        try:
            sequences[name] = _route_sequence(url, song_bytes)
            monkeypatch.setenv("AUDSEP_API_KEY", "sekrit")
            sequences[name] += [(p, _http("GET", url + p)[0], None)
                                for p in ("/status/x", "/download/a/b", "/health")]
            monkeypatch.delenv("AUDSEP_API_KEY")
        finally:
            srv.shutdown()
            srv.server_close()
    assert sequences["port"] == sequences["jax"]
    codes = [status for _, status, _ in sequences["port"]]
    assert codes == [200] * 5 + [404] * 4 + [400, 400, 404, 200, 200, 200, 404, 401, 401, 200]


# ---------------------------------------------------------------------------
# One real separation over HTTP


def _stem_label(path):
    """``<upload>_(Vocals)_<model>.wav`` -> ``Vocals``: a served stem's name
    starts with its upload's task id."""
    return os.path.basename(path).split("_(")[1].split(")")[0]


def test_port_server_separation_matches_direct_call_and_jax_server(tmp_path):
    """A small Mel-RoFormer (``tests/test_ensemble_e2e._make_model``) through
    the port's server over HTTP: its stems equal the port's direct CPU
    ``separate`` of the same file, and are >= 40 dB against the JAX
    server's stems for the same upload."""
    from audio_separator_tpu.io import audio as jax_audio_io
    from audio_separator_tpu.remote.server import serve as jax_serve
    from test_ensemble_e2e import _make_model

    model_dir = str(tmp_path / "models")
    os.makedirs(model_dir)
    (tmp_path / "models" / "download_checks.json").write_text("{}")
    model = _make_model(model_dir, "remote", seed=9)
    song = _song(tmp_path / "song.wav", seconds=1.0, seed=3)

    direct_dir = str(tmp_path / "direct")
    sep = Separator(model_file_dir=model_dir, output_dir=direct_dir, output_format="wav",
                    device="cpu", log_level=logging.WARNING)
    sep.load_model(model)
    direct = {_stem_label(f): audio_io.load_audio(os.path.join(direct_dir, f))[0]
              for f in sep.separate(song)}
    assert len(direct) == 2

    remote = {}
    for name, make in (("port", lambda: serve(host="127.0.0.1", port=0,
                                              work_dir=str(tmp_path / "port"),
                                              model_file_dir=model_dir, device="cpu")),
                       ("jax", lambda: jax_serve(host="127.0.0.1", port=0,
                                                 work_dir=str(tmp_path / "jax"),
                                                 model_file_dir=model_dir))):
        srv = make()
        url = _running(srv)
        try:
            dl = str(tmp_path / f"dl-{name}")
            result = AudioSeparatorAPIClient(url).separate_audio_and_wait(
                file_path=song, model=model, output_format="wav", output_dir=dl,
                timeout=WAIT_S, poll_interval=0.05)
            load = (audio_io if name == "port" else jax_audio_io).load_audio
            remote[name] = {_stem_label(f): load(f)[0] for f in result["downloaded_files"]}
        finally:
            srv.shutdown()
            srv.server_close()

    assert sorted(remote["port"]) == sorted(remote["jax"]) == sorted(direct)
    for stem, want in direct.items():
        got = remote["port"][stem]
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)
        ref = remote["jax"][stem]
        sdr = 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2), 1e-30))
        assert sdr >= 40.0, (stem, sdr)


def test_remote_cli_against_port_server(http_server, capsys, monkeypatch, tmp_path):
    """``audio-separator-torch-remote`` (``remote/cli.main``) against the
    port's server: version, model listing, a job through ``separate`` and
    its ``status``."""
    from audio_separator_tpu_torch import __version__
    from audio_separator_tpu_torch.remote import cli

    server, url = http_server
    cli.main(["--api_url", url, "version"])
    assert capsys.readouterr().out.strip() == __version__
    cli.main(["--api_url", url, "models", "--format", "json"])
    assert "MDXC" in json.loads(capsys.readouterr().out)

    monkeypatch.setattr(Separator, "load_model", _fake_load_model)
    monkeypatch.setattr(Separator, "separate",
                        lambda self, path, names=None: [_emit(self, path)])
    cli.main(["--api_url", url, "separate", _song(tmp_path / "song.wav"), "-m", "m.ckpt",
              "--output_format", "wav", "--output_dir", str(tmp_path / "dl"),
              "--poll_interval", "0.05"])
    result = json.loads(capsys.readouterr().out)
    assert len(result["files"]) == 1 and os.path.exists(result["downloaded"][0])
    cli.main(["--api_url", url, "status", result["task_id"]])
    assert json.loads(capsys.readouterr().out)["status"] == "completed"
    with pytest.raises(SystemExit):
        cli.main(["version"])  # no --api_url and no AUDIO_SEPARATOR_API_URL
