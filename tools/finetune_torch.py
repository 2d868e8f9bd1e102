#!/usr/bin/env python
"""Runnable fine-tuning loop for the PyTorch/CUDA port's RoFormer (synthetic data).

Shows the loop around ``audio_separator_tpu_torch.training.make_train_step``:
real use replaces the synthetic batches with (mix, stems) pairs cut into
training segments and loads a converted checkpoint
(``models/convert.load_jax_params``) instead of the seeded init. The step is
float32; on a CUDA card it runs the hand-written kernels forward and
backward.

    python tools/finetune_torch.py --steps 20                  # on the card
    python tools/finetune_torch.py --device cpu --steps 3      # plain versions
    python tools/finetune_torch.py --save tuned.npz            # the .npz of models.convert.save_params
    python tools/finetune_torch.py --mesh --tp 2               # sharded over the local cards

``--mesh`` lays the model out on a ``(dp, tp)`` device mesh
(``parallel/mesh.py``): every local card, ``tp`` of them a tensor-parallel
row (``--tp``), the batch split over the rows. With ``--device cpu`` the
mesh is ``2 × tp`` CPU handles. ``--batch`` must be a multiple of the rows.
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh", action="store_true",
                        help="shard over a (dp, tp) device mesh (data rows x --tp)")
    parser.add_argument("--tp", type=int, default=1, help="tensor-parallel width of --mesh")
    parser.add_argument("--save", default=None,
                        help="write the fine-tuned parameter tree here (.npz, the layout "
                             "models.convert.save_params writes and load_params reads)")
    args = parser.parse_args(argv)

    import torch

    from audio_separator_tpu_torch.models.convert import (export_jax_params, load_jax_params,
                                                          save_params)
    from audio_separator_tpu_torch.models.init_params import init_roformer_params
    from audio_separator_tpu_torch.models.roformer import Roformer, RoformerConfig
    from audio_separator_tpu_torch.parallel.mesh import make_mesh, shard_model
    from audio_separator_tpu_torch.training import make_train_step

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("finetune_torch: no CUDA device (pass --device cpu to train on the "
                         "CPU with the kernels' plain versions)")
    device = torch.device(args.device)
    cfg = RoformerConfig(
        kind="bs", dim=args.dim, depth=args.depth, stereo=True, num_stems=2,
        time_transformer_depth=1, freq_transformer_depth=1,
        freqs_per_bands=(2, 2, 4, 8, 16, 32, 64, 129),
        dim_head=64, heads=4, stft_n_fft=512, stft_hop_length=128,
        stft_win_length=512, mask_estimator_depth=1)
    chunk = cfg.stft_hop_length * 31
    model = load_jax_params(Roformer(cfg), init_roformer_params(cfg, seed=args.seed)).to(device)
    mesh = None
    if args.mesh:
        # every local card; on the CPU two rows of tp handles
        mesh = make_mesh(tp=args.tp, devices=[device] * 2 * args.tp
                         if device.type == "cpu" else None)
        model = shard_model(model, mesh)  # before the optimizer: it takes the shards
        print(f"mesh={mesh.shape}", flush=True)
    step = make_train_step(cfg, model, torch.optim.Adam(model.parameters(), lr=args.lr),
                           mesh=mesh, stft_n_fft=256, window_sizes=(256, 128), hop_length=64)
    rng = np.random.default_rng(args.seed)

    def batch():
        mix = rng.standard_normal((args.batch, 2, chunk)).astype(np.float32) * 0.2
        tgt = rng.standard_normal((args.batch, cfg.num_stems, 2, chunk)).astype(np.float32) * 0.2
        return (torch.from_numpy(mix).to(device),
                torch.from_numpy(0.5 * tgt + 0.5 * mix[:, None]).to(device))

    print(f"device={device} chunk={chunk} dim={args.dim} depth={args.depth}", flush=True)
    for i in range(args.steps):
        mix, tgt = batch()
        t0 = time.perf_counter()
        loss = float(step(mix, tgt))  # float() waits for the step
        print(f"step {i:3d}: loss={loss:.4f} ({time.perf_counter() - t0:.2f}s)", flush=True)

    if args.save:
        save_params(args.save, export_jax_params(model))
        print(f"saved fine-tuned params to {args.save}", flush=True)


if __name__ == "__main__":
    main()
