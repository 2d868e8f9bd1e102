"""Clips through the remote service's HTTP API: closed-loop clients.

Set-up writes the seed's clips and the seeded model, starts the service
(``remote.server.serve``) in this process on ``127.0.0.1`` and a free port
with its default of one worker, its work directory and model directory in
the run's temporary directory, and sends one warm-up job. It then starts the
clients in a process of their own (``benchlib/http_clients.py``): each
uploads a clip (``POST /separate``, WAV out, bf16 autocast as the cell's
dtype says), polls ``GET /status`` at the traffic's interval until the job
ends, downloads every stem (``GET /download``) and uploads its next clip.
The window opens once every client has finished a job, so the loop is in
steady state.

The window ends at the first download completed at or after ``--seconds``.
The rate metric is the audio of the jobs whose stems were all downloaded in
the window, over the window; a failed job adds none. Each such job's time,
upload start to last stem downloaded, is kept for ``job_ms.remote``.

The check runs the plain reference over ``CHECK_JOBS`` of those jobs, the
longest and the others drawn from the seed, and compares their stems as
downloaded; the clients keep those jobs' stems and no others.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time

from benchlib import http_clients, seeded
from reference import separate

CHECK_JOBS = 2


class Clients:
    """The client process, and the records of its jobs as they end (times on
    this process's ``time.perf_counter``)."""

    def __init__(self, job: dict):
        self.done, self.cond = [], threading.Condition()
        self.saved, self.ended = None, False
        self.shift = time.perf_counter() - time.monotonic()
        self.proc = subprocess.Popen([sys.executable, "-u", http_clients.__file__],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.proc.stdin.write(json.dumps(job) + "\n")
        self.proc.stdin.flush()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            msg = json.loads(line)
            with self.cond:
                if "saved" in msg:
                    self.saved = {int(k): v for k, v in msg["saved"].items()}
                else:
                    for key in ("t_start", "t_end"):
                        if msg[key] is not None:
                            msg[key] += self.shift
                    self.done.append(msg)
                self.cond.notify_all()
        with self.cond:
            self.ended = True
            self.cond.notify_all()

    def wait(self, predicate, timeout=None):
        """Until ``predicate(done)`` holds or the client process has ended."""
        with self.cond:
            return self.cond.wait_for(lambda: self.ended or predicate(self.done), timeout)

    def stop(self, save: list, directory: str, timeout: float) -> bool:
        """Stop the clients, have them write the stems of the jobs ``save``
        names under ``directory``, and wait for the process to end."""
        try:
            self.proc.stdin.write(json.dumps({"save": save, "dir": directory}) + "\n")
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout)
            clean = True
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            clean = False
        self.reader.join(30)
        return clean


def setup(ctx) -> None:
    from audio_separator_tpu_torch.models.convert import finish_cache_writes
    from audio_separator_tpu_torch.remote.server import serve

    cell, cfg, traffic = ctx.cell, ctx.cell.config, ctx.cell.traffic
    fam = cell.family()
    model_dir = os.path.join(ctx.tmp, "models")
    name = fam.write_model(cfg, ctx.seed, model_dir, ctx.device)
    lengths = seeded.spread(traffic["min_s"], traffic["max_s"], traffic["count"])
    paths = seeded.write_songs(os.path.join(ctx.tmp, "clips"), ctx.seed, lengths,
                               traffic["rate"], ctx.device)
    clips = [{"index": i, "name": os.path.basename(path), "path": path, "seconds": seconds}
             for i, (path, seconds) in enumerate(paths)]
    warm_path, warm_s = seeded.write_songs(os.path.join(ctx.tmp, "warm"), ctx.seed + 1,
                                           [traffic["warmup_s"]], traffic["rate"],
                                           ctx.device)[0]
    warm = http_clients.read_clip({"index": -1, "name": "warm.wav", "path": warm_path,
                                   "seconds": warm_s})
    server = serve("127.0.0.1", 0, model_file_dir=model_dir,
                   work_dir=os.path.join(ctx.tmp, "work"), device=str(ctx.device))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    fields = {"model": name, "output_format": "wav",
              "use_autocast": "true" if cell.autocast() else "false"}
    first = http_clients.run_job(base, warm, fields, traffic["poll_s"])
    if not first["ok"]:
        raise RuntimeError(f"the warm-up job failed: {first['error']}")
    finish_cache_writes()  # the converted checkpoint's cache file: not inside the window
    count = int(traffic["clients"])
    clients = Clients({"base": base, "clips": clips, "fields": fields, "clients": count,
                       "poll_s": traffic["poll_s"]})
    clients.wait(lambda done: len({r["client"] for r in done}) >= count, timeout=600)
    ctx.state.update(server=server, thread=thread, clients=clients, clips=clips)


def window(ctx, win) -> None:
    clients = ctx.state["clients"]
    t0 = win.t0
    clients.wait(lambda done: any(r["t_end"] - t0 >= ctx.seconds for r in done), timeout=900)
    win.close()
    t1 = win.t1
    with clients.cond:
        records = [r for r in clients.done if t0 < r["t_end"] <= t1]
    served = [r for r in records if r["ok"]]
    ctx.attempted, ctx.failed = len(records), len(records) - len(served)
    ctx.metrics[ctx.cell.spec["metric"]] = sum(r["seconds"] for r in served) / win.seconds
    ctx.extras.update(job_ms=[1000.0 * (r["t_end"] - r["t_start"]) for r in served],
                      audio_s=sum(r["seconds"] for r in served), window_s=win.seconds)
    picks = set()
    if served:
        longest = max(served, key=lambda r: r["seconds"])
        others = [r["seq"] for r in served if r is not longest]
        rng = seeded.numpy_rng(ctx.seed, "check")
        picks = {longest["seq"], *(int(x) for x in rng.choice(
            others, size=min(CHECK_JOBS - 1, len(others)), replace=False))}
    ctx.state["checked"] = [r for r in served if r["seq"] in picks]
    ctx.extras.setdefault("notes", {})["jobs"] = (
        f"{len(served)} served in the window, {ctx.extras['audio_s']:.1f} s of audio, "
        f"median {statistics.median(ctx.extras['job_ms']) if served else 0:.0f} ms")
    for r in records:
        if not r["ok"]:
            ctx.extras.setdefault("notes", {})[f"job of clip {r['clip']} failed"] = r["error"]


def release(ctx) -> None:
    from audio_separator_tpu_torch.ops import fn_cache

    clients, server = ctx.state["clients"], ctx.state["server"]
    out_dir = os.path.join(ctx.tmp, "check")
    os.makedirs(out_dir, exist_ok=True)
    if not clients.stop([r["seq"] for r in ctx.state["checked"]], out_dir, timeout=180):
        ctx.extras.setdefault("notes", {})["clients"] = "still running at 180 s: killed"
    ctx.state["stems"] = clients.saved or {}
    server.shutdown()
    server.server_close()
    ctx.state["thread"].join(30)
    for key in ("server", "clients", "thread"):
        ctx.state.pop(key, None)
    fn_cache.clear()
    gc.collect()


def check(ctx) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, cfg = ctx.cell, ctx.cell.config
    fam = cell.family()
    checked, clips, stems = ctx.state["checked"], ctx.state["clips"], ctx.state["stems"]
    limit = cell.spec["limits"]["stem_rel_err"]
    if not checked:
        ctx.check("stem_rel_err", float("inf"), limit)
        return
    model = fam.reference(cfg, ctx.device, fam.seeded_state(cfg, ctx.seed, ctx.device))
    params = cell.spec.get("params", {})
    worst = 0.0
    for job in checked:
        clip = clips[job["clip"]]
        ref = fam.separate_song(model, separate.decode(clip["path"]), cfg, params, ctx.device)
        errors = separate.stem_errors(stems.get(job["seq"], []), ref)
        ctx.extras.setdefault("notes", {})[f"check job {job['seq']} (clip {job['clip']}, "
                                           f"{clip['seconds']:.1f} s)"] = errors
        worst = max(worst, max(errors.values()))
    ctx.check("stem_rel_err", worst, limit)
