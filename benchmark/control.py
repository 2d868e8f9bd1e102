"""Readings that set a cell's limits: the control, and the faults a training
cell can have, at the cell's own size, one line a seed.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--fault half_batch]

The benchmark's own runs never run this. For a cell that separates songs or
clips, the control is the plain reference with TF32 on (the precision below
the float32 the configuration states) in the program's place: it separates a
song of the seed's pool, the longest, and its stems, written as 16-bit WAV
as the program writes them, are compared with the float32 reference's as a
run compares the program's. For a training cell, the control is the
reference's first steps with every product's inputs rounded to fp8 (one step
below bf16); ``--fault half_batch`` instead reads the program with half of
each batch left out (the mean over the rest), and ``--fault unchanged`` the
program with its optimizer's update left out, and ``--fault none`` the
program as it is (a sound reading, for the leaf gaps over each leaf's own
norm that a run records beside the compared ones).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
for _path in (os.path.dirname(BENCH), BENCH):  # the program's package, then the harness
    if _path not in sys.path:
        sys.path.insert(0, _path)


def song_control(ctx) -> dict:
    import torch

    from benchlib import seeded
    from reference import separate

    cell, cfg, traffic = ctx.cell, ctx.cell.config, ctx.cell.traffic
    fam = cell.family()
    lengths = seeded.spread(traffic["min_s"], traffic["max_s"], traffic["count"])
    songs = seeded.write_songs(os.path.join(ctx.tmp, "songs"), ctx.seed, lengths,
                               traffic["rate"], ctx.device)
    path, seconds = max(songs, key=lambda s: s[1])
    mix = separate.decode(path)
    params = cell.spec.get("params", {})
    model = fam.reference(cfg, ctx.device, fam.seeded_state(cfg, ctx.seed, ctx.device))
    out = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        out[tf32] = fam.separate_song(model, mix, cfg, params, ctx.device)
    files = []
    for name, stem in out[True].items():
        f = os.path.join(ctx.tmp, f"control_({name})_.wav")
        separate.write_wav(f, stem, traffic["rate"])
        files.append(f)
    errors = separate.stem_errors(files, out[False])
    return {"song_s": seconds, "stem_rel_err": max(errors.values()), "stems": errors}


def train_control(ctx, fault) -> dict:
    import torch

    finetune = ctx.cell.driver
    reference = finetune.reference_steps(ctx)
    if fault is None:
        from reference.train import float8_products

        control = finetune.reference_steps(ctx, products=float8_products)
    else:
        model, opt, step = finetune.build_program(ctx)
        if fault == "half_batch":
            run = step

            def step(mix, target):
                half = mix.shape[0] // 2
                return run(mix[:half], target[:half])
        elif fault == "unchanged":
            opt.step = lambda *a, **k: None
        elif fault != "none":
            raise SystemExit(f"unknown fault {fault}")
        control = finetune.first_steps(ctx, model, opt, step)
        del model, opt, step
        torch.cuda.empty_cache()
    gaps = finetune.compare(control, reference)
    return {**gaps, "losses": control["losses"], "reference_losses": reference["losses"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)

    import run

    run.checkout_caches(os.path.dirname(BENCH))
    import torch

    from benchlib import manifest

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = manifest.Cell(args.workload, manifest.manifest())
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="bench-control-",
                               dir=os.environ.get("TMPDIR") or tempfile.gettempdir())
        try:
            ns = argparse.Namespace(seed=seed, seconds=0, trace=0)
            ctx = run.Context(cell, ns, torch.device("cuda", 0), tmp)
            t0 = time.perf_counter()
            if cell.spec["driver"] == "finetune":
                reading = train_control(ctx, args.fault)
                kind = args.fault or "fp8 products"
            else:
                reading = song_control(ctx)
                kind = "tf32"
            reading.update(workload=args.workload, seed=seed, control=kind,
                           seconds=time.perf_counter() - t0,
                           device=torch.cuda.get_device_name(0))
            print(json.dumps(reading), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
