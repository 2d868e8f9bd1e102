"""Songs through ``Separator.separate``: one caller in a closed loop.

Set-up writes the seed's pool of 16-bit stereo WAV songs (the traffic's
lengths, in the seed's order) and the seeded model, builds a ``Separator``
with the cell's options, loads the model and separates one warm-up clip,
which runs every shape the window runs (the engine pads each window batch
to its full size). The window separates the pool's songs one after another,
cycling, and ends when the first song completes at or after ``--seconds``:
the song in flight counts, with its time. The cell's rate metric is the
audio of all songs completed over all the time of the window.

The check separates one of the window's songs, drawn from the seed before
the window opens, with the family's plain reference and compares its stems
as written to disk. Only that song's stems, and the newest song's (the
check's song where the window ends before the drawn one), stay on disk:
every other song's are deleted as the next song ends.
"""

from __future__ import annotations

import gc
import os
import time

import torch

from benchlib import seeded
from benchlib.trace import span
from reference import separate


def setup(ctx) -> None:
    from audio_separator_tpu_torch.models.convert import finish_cache_writes
    from audio_separator_tpu_torch.separator import Separator

    cell, cfg, traffic = ctx.cell, ctx.cell.config, ctx.cell.traffic
    fam = cell.family()
    params = cell.spec.get("params", {})
    model_dir = os.path.join(ctx.tmp, "models")
    name = fam.write_model(cfg, ctx.seed, model_dir, ctx.device)
    lengths = seeded.spread(traffic["min_s"], traffic["max_s"], traffic["count"])
    songs = seeded.write_songs(os.path.join(ctx.tmp, "songs"), ctx.seed, lengths,
                               traffic["rate"], ctx.device)
    warm = seeded.write_songs(os.path.join(ctx.tmp, "warm"), ctx.seed + 1,
                              [traffic["warmup_s"]], traffic["rate"], ctx.device)
    out_dir = os.path.join(ctx.tmp, "out")
    sep = Separator(model_file_dir=model_dir, output_dir=out_dir, output_format="WAV",
                    device=str(ctx.device), use_autocast=cell.autocast(),
                    **fam.separator_kwargs(params))
    sep.load_model(name)
    for out in sep.separate(warm[0][0]):
        os.remove(_full(out_dir, out))
    finish_cache_writes()  # the converted checkpoint's cache file: not inside the window
    checked = int(seeded.numpy_rng(ctx.seed, "check").integers(len(songs)))
    ctx.state.update(sep=sep, songs=songs, out_dir=out_dir, params=params, checked=checked)


def _full(out_dir: str, path: str) -> str:
    return path if os.path.isabs(path) else os.path.join(out_dir, path)


def window(ctx, win) -> None:
    sep, songs, out_dir = ctx.state["sep"], ctx.state["songs"], ctx.state["out_dir"]
    checked = ctx.state["checked"]
    done, i, newest = [], 0, None
    while True:
        path, seconds = songs[i % len(songs)]
        ctx.attempted += 1
        try:
            with span("song", ctx.trace):
                outs = sep.separate(path)
        except Exception as exc:  # a failed song counts, the loop goes on
            ctx.failed += 1
            ctx.extras.setdefault("notes", {})[f"song {i} failed"] = repr(exc)
            outs = None
        if outs is not None:
            files = []
            for out in outs:
                src = _full(out_dir, out)
                dst = os.path.join(out_dir, f"w{i:03d}-{os.path.basename(src)}")
                os.replace(src, dst)  # each song's stems under their own name
                files.append(dst)
            if newest is not None and newest["index"] != checked:
                for f in newest["files"]:
                    os.remove(f)
                newest["files"] = []
            newest = {"index": i, "path": path, "seconds": seconds, "files": files}
            done.append(newest)
        i += 1
        if time.perf_counter() - win.t0 >= ctx.seconds:
            break
    win.close()
    audio = sum(s["seconds"] for s in done)
    ctx.metrics[ctx.cell.spec["metric"]] = audio / win.seconds
    ctx.state["check_song"] = next((s for s in done if s["index"] == checked),
                                   done[-1] if done else None)
    fam = ctx.cell.family()
    rate = ctx.cell.traffic["rate"]
    ctx.extras["windows"] = sum(fam.windows(int(round(s["seconds"] * rate)),
                                            ctx.cell.config, ctx.state["params"]) for s in done)
    ctx.extras["audio_s"] = audio
    ctx.extras["window_s"] = win.seconds
    ctx.extras.setdefault("notes", {})["songs"] = (
        f"{len(done)} in the window, {audio:.1f} s of audio, "
        f"{[round(s['seconds']) for s in done]}")


def release(ctx) -> None:
    from audio_separator_tpu_torch.ops import fn_cache

    ctx.state.pop("sep", None)
    fn_cache.clear()
    gc.collect()


def check(ctx) -> None:
    """The reference over the window's song drawn from the seed, float32
    with TF32 off; the worst stem's relative error in 16-bit units."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, cfg = ctx.cell, ctx.cell.config
    fam = cell.family()
    song, params = ctx.state["check_song"], ctx.state["params"]
    limit = cell.spec["limits"]["stem_rel_err"]
    if song is None:
        ctx.check("stem_rel_err", float("inf"), limit)
        return
    model = fam.reference(cfg, ctx.device, fam.seeded_state(cfg, ctx.seed, ctx.device))
    ref = fam.separate_song(model, separate.decode(song["path"]), cfg, params, ctx.device)
    errors = separate.stem_errors(song["files"], ref)
    ctx.extras.setdefault("notes", {})[f"check song {song['index']}"] = errors
    ctx.check("stem_rel_err", max(errors.values()), limit)
    if ctx.trace:
        from torch.utils.flop_counter import FlopCounterMode

        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(fam.window_input(cfg, ctx.device))
        ctx.extras["flops_per_window"] = counter.get_total_flops()
