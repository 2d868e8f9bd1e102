"""The port's remote API client (``audio_separator_tpu_torch/remote/
api_client``) over a scripted ``requests`` session: the cases of
``tests/test_api_client.py``, plus ``download_file``, which hashes the name
with the port's own ``server.generate_file_hash``."""

import json

import pytest

from audio_separator_tpu.remote.server import generate_file_hash as jax_file_hash
from audio_separator_tpu_torch.remote.api_client import AudioSeparatorAPIClient

from test_api_client import FakeResponse, FakeSession
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def client(monkeypatch):
    monkeypatch.delenv("AUDSEP_API_KEY", raising=False)
    c = AudioSeparatorAPIClient("http://host:1/")
    c.session = FakeSession()
    return c


def test_api_key_header_from_env(monkeypatch):
    monkeypatch.setenv("AUDSEP_API_KEY", "sekrit")
    c = AudioSeparatorAPIClient("http://host:1")
    assert c.session.headers["X-API-Key"] == "sekrit"
    # explicit arg wins over env
    c2 = AudioSeparatorAPIClient("http://host:1", api_key="other")
    assert c2.session.headers["X-API-Key"] == "other"


def test_separate_audio_argument_validation(client, tmp_path):
    with pytest.raises(ValueError, match="either file_path or gcs_uri"):
        client.separate_audio()
    f = tmp_path / "x.wav"
    f.write_bytes(b"RIFF")
    with pytest.raises(ValueError, match="not both"):
        client.separate_audio(file_path=str(f), gcs_uri="gs://b/x.wav")
    with pytest.raises(FileNotFoundError):
        client.separate_audio(file_path=str(tmp_path / "missing.wav"))


def test_separate_audio_model_selection_priority(client, tmp_path):
    f = tmp_path / "x.wav"
    f.write_bytes(b"RIFF")
    client.session.route("POST", "/separate",
                         [FakeResponse({"task_id": "t1", "status": "queued"})])
    out = client.separate_audio(file_path=str(f), model="solo.ckpt",
                                models=["a.ckpt", "b.ckpt"], preset="karaoke")
    assert out["task_id"] == "t1"
    _, _, kwargs = client.session.calls[-1]
    data = kwargs["data"]
    # preset beats models beats model (server-side semantics mirrored)
    assert data["preset"] == "karaoke"
    assert "models" not in data and "model" not in data

    client.separate_audio(file_path=str(f), model="solo.ckpt",
                          models=["a.ckpt", "b.ckpt"])
    data = client.session.calls[-1][2]["data"]
    assert json.loads(data["models"]) == ["a.ckpt", "b.ckpt"]
    assert "model" not in data


def test_wait_polls_to_completion_and_downloads(client, tmp_path):
    f = tmp_path / "x.wav"
    f.write_bytes(b"RIFF")
    client.session.route("POST", "/separate",
                         [FakeResponse({"task_id": "t2", "status": "queued"})])
    client.session.route("GET", "/status/t2", [
        FakeResponse({"status": "queued"}),
        FakeResponse({"status": "processing", "progress": 50}),
        FakeResponse({"status": "completed",
                      "files": [{"hash": "h1", "filename": "x_(Vocals)_m.flac"}]}),
    ])
    client.session.route("GET", "/download/t2/h1",
                         [FakeResponse(content=b"FLACDATA")])
    out = client.separate_audio_and_wait(
        file_path=str(f), model="m.ckpt", output_dir=str(tmp_path),
        poll_interval=0.0)
    assert out["status"]["status"] == "completed"
    assert len(out["downloaded_files"]) == 1
    with open(out["downloaded_files"][0], "rb") as fh:
        assert fh.read() == b"FLACDATA"


def test_wait_raises_on_remote_error(client, tmp_path):
    f = tmp_path / "x.wav"
    f.write_bytes(b"RIFF")
    client.session.route("POST", "/separate",
                         [FakeResponse({"task_id": "t3", "status": "queued"})])
    client.session.route("GET", "/status/t3",
                         [FakeResponse({"status": "error", "error": "bad model"})])
    with pytest.raises(RuntimeError, match="bad model"):
        client.separate_audio_and_wait(file_path=str(f), model="m",
                                       poll_interval=0.0)


def test_wait_times_out(client, tmp_path):
    f = tmp_path / "x.wav"
    f.write_bytes(b"RIFF")
    client.session.route("POST", "/separate",
                         [FakeResponse({"task_id": "t4", "status": "queued"})])
    client.session.route("GET", "/status/t4",
                         [FakeResponse({"status": "processing"})])
    with pytest.raises(TimeoutError):
        client.separate_audio_and_wait(file_path=str(f), model="m",
                                       timeout=0, poll_interval=0.0)


def test_download_filename_cannot_escape_output_dir(client, tmp_path):
    client.session.route("GET", "/download/t5/hh",
                         [FakeResponse(content=b"X")])
    out = client.download_file_by_hash("t5", "hh", "../../../etc/evil.wav",
                                       output_dir=str(tmp_path))
    assert out == str(tmp_path / "evil.wav")  # traversal stripped


def test_list_models_filter(client):
    client.session.route("GET", "/models", [FakeResponse({
        "Model A": {"stems": ["vocals"]},
        "Model B": {"stems": ["drums"]},
    })])
    got = client.list_models(filter_by="vocals")
    assert list(got) == ["Model A"]


def test_server_version(client):
    client.session.route("GET", "/health",
                         [FakeResponse({"status": "healthy", "version": "9.9"})])
    assert client.get_server_version() == "9.9"


def test_download_file_hashes_the_name_like_the_servers(client, tmp_path):
    from audio_separator_tpu_torch.remote.server import generate_file_hash

    name = "x_(Vocals)_m.wav"
    assert generate_file_hash(name) == jax_file_hash(name)
    client.session.route("GET", f"/download/t6/{generate_file_hash(name)}",
                         [FakeResponse(content=b"WAVDATA")])
    out = client.download_file("t6", name, output_dir=str(tmp_path))
    assert out == str(tmp_path / name)
    with open(out, "rb") as f:
        assert f.read() == b"WAVDATA"
