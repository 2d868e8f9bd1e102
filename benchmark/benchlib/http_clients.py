"""Closed-loop HTTP clients of the remote service, in a process of their own.

    python3 benchmark/benchlib/http_clients.py     (driven through its stdin)

The remote driver starts this file with the standard library alone, so that
the clients' own work (multipart bodies, JSON, polling) does not share the
interpreter of the service under test. Its standard input takes two JSON
lines: the first starts the clients,

    {"base": url, "clips": [{"index", "name", "path", "seconds"}],
     "fields": {form fields}, "clients": n, "poll_s": s}

and the second stops them, ``{"save": [seq, ...], "dir": path}``: each
client finishes the job it is in and starts no other, and the stems of the
jobs named are written under ``dir``. Each job is one line on standard
output as it ends, ``{"seq", "client", "clip", "seconds", "t_start",
"t_end", "ok", "error"}`` (times by ``time.monotonic``), and the last line
is ``{"saved": {seq: [path, ...]}}``.

Each client takes the next clip of the pool's order as it starts a job,
uploads it (``POST /separate``), polls ``GET /status`` every ``poll_s``
until the job ends, downloads every stem (``GET /download``) and starts its
next job.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.request
import uuid


def _multipart(fields: dict, filename: str, data: bytes):
    boundary = uuid.uuid4().hex
    parts = []
    for key, value in fields.items():
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{key}\"\r\n\r\n"
                     f"{value}\r\n".encode())
    parts.append(f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                 f"filename=\"{filename}\"\r\nContent-Type: audio/wav\r\n\r\n".encode())
    parts.append(data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.read()


def run_job(base: str, clip: dict, fields: dict, poll_s: float) -> dict:
    """One job from upload to its last stem downloaded; ``stems`` maps each
    stem's file name to its bytes."""
    t0 = time.monotonic()
    body, ctype = _multipart(fields, clip["name"], clip["data"])
    req = urllib.request.Request(f"{base}/separate", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=600) as r:
        task = json.loads(r.read())["task_id"]
    while True:
        status = json.loads(_get(f"{base}/status/{task}"))
        if status.get("status") in ("completed", "error"):
            break
        time.sleep(poll_s)
    stems = {}
    if status["status"] == "completed":
        for f in status["files"]:
            stems[f["filename"]] = _get(f"{base}/download/{task}/{f['hash']}")
    ok = status["status"] == "completed" and bool(stems)
    return {"clip": clip["index"], "seconds": clip["seconds"], "t_start": t0,
            "t_end": time.monotonic(), "ok": ok, "stems": stems,
            "error": None if ok else status.get("error") or status.get("status")}


def read_clip(clip: dict) -> dict:
    with open(clip["path"], "rb") as f:
        return {**clip, "data": f.read()}


def serve_clients(job: dict, stdin, stdout) -> None:
    clips = [read_clip(c) for c in job["clips"]]
    stop, lock = threading.Event(), threading.Lock()
    stems, order = {}, {"next": 0, "seq": 0}

    def loop(c):
        while not stop.is_set():
            with lock:
                clip = clips[order["next"] % len(clips)]
                order["next"] += 1
            try:
                rec = run_job(job["base"], clip, job["fields"], job["poll_s"])
            except Exception as exc:  # a failed request counts as a failed job
                rec = {"clip": clip["index"], "seconds": clip["seconds"], "t_start": None,
                       "t_end": time.monotonic(), "ok": False, "stems": {},
                       "error": repr(exc)}
            with lock:
                rec["seq"], rec["client"] = order["seq"], c
                order["seq"] += 1
                stems[rec["seq"]] = rec.pop("stems")
                stdout.write(json.dumps(rec) + "\n")
                stdout.flush()

    threads = [threading.Thread(target=loop, args=(c,)) for c in range(int(job["clients"]))]
    for t in threads:
        t.start()
    line = stdin.readline()
    stop.set()
    for t in threads:
        t.join()
    request = json.loads(line) if line.strip() else {"save": [], "dir": None}
    saved = {}
    for seq in request["save"]:
        saved[seq] = []
        for name, data in stems.get(seq, {}).items():
            path = os.path.join(request["dir"], f"{seq}-{name}")
            with open(path, "wb") as f:
                f.write(data)
            saved[seq].append(path)
    stdout.write(json.dumps({"saved": saved}) + "\n")
    stdout.flush()


def main() -> int:
    serve_clients(json.loads(sys.stdin.readline()), sys.stdin, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
