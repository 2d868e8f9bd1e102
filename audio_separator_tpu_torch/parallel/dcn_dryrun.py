"""Multi-process mesh dry run: proves that a mesh whose data axis spans
processes reduces a globally sharded array and takes a sharded training
step whose result every process agrees on.

Run N copies with the ``AUDSEP_*`` contract of
``parallel/mesh.init_distributed_from_env``::

    AUDSEP_COORDINATOR=127.0.0.1:29511 AUDSEP_NUM_PROCESSES=2 AUDSEP_PROCESS_ID=0 \\
      AUDSEP_DRYRUN_CPU_HANDLES=4 python -m audio_separator_tpu_torch.parallel.dcn_dryrun &
    AUDSEP_COORDINATOR=127.0.0.1:29511 AUDSEP_NUM_PROCESSES=2 AUDSEP_PROCESS_ID=1 \\
      AUDSEP_DRYRUN_CPU_HANDLES=4 python -m audio_separator_tpu_torch.parallel.dcn_dryrun

``AUDSEP_DRYRUN_CPU_HANDLES=n`` gives each process ``n`` CPU handles and the
``gloo`` backend; without it the process takes its local CUDA devices and
``nccl``. ``AUDSEP_DRYRUN_TP`` is the model axis (default 2).

Each process sums its blocks of a ``(dp·8, tp·16)`` array sharded over
``("data", "model")`` and ``all_reduce``s the sums; then it takes one SGD
step of a depth-1 BS-RoFormer (seeded weights, tensor-parallel over the
model axis) on its part of a seeded global batch, one item a data row, and
prints a checksum of the updated weights. The port's counterpart of the JAX
package's ``tools/dcn_dryrun.py``: one JSON line with the same keys, plus
``checksum``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..models.convert import export_jax_params, flatten_tree, load_jax_params
from ..models.init_params import init_roformer_params
from ..models.roformer import Roformer, RoformerConfig
from ..training import make_train_step
from .mesh import Mesh, init_distributed_from_env, make_mesh, shard_model

CFG = RoformerConfig(kind="bs", dim=32, depth=1, stereo=True, num_stems=2,
                     time_transformer_depth=1, freq_transformer_depth=1,
                     freqs_per_bands=(2, 2, 4, 8, 16, 32, 64, 129), dim_head=8, heads=4,
                     stft_n_fft=512, stft_hop_length=128, stft_win_length=512,
                     mask_estimator_depth=1)
LOSS_KW = dict(stft_n_fft=256, window_sizes=(256, 128), hop_length=64)


def global_batch(n: int, seed: int = 0):
    """The seeded global batch of ``n`` items: ``(mix, target)``."""
    rng = np.random.default_rng(seed)
    chunk = CFG.stft_hop_length * 15
    mix = rng.standard_normal((n, 2, chunk)).astype(np.float32) * 0.2
    target = rng.standard_normal((n, CFG.num_stems, 2, chunk)).astype(np.float32) * 0.2
    return mix, 0.5 * target + 0.5 * mix[:, None]


def sgd_checksum(mesh: Mesh, lr: float = 1e-2) -> float:
    """One SGD step of the seeded RoFormer over ``mesh`` on this process's
    part of the global batch (one item a data row); the sum of the absolute
    values of every updated weight, gathered."""
    model = shard_model(load_jax_params(Roformer(CFG), init_roformer_params(CFG, seed=0)), mesh)
    step = make_train_step(CFG, model, torch.optim.SGD(model.parameters(), lr=lr), mesh=mesh,
                           **LOSS_KW)
    mix, target = global_batch(mesh.shape["data"])
    rows = slice(mesh.process_index * mesh.local_rows, (mesh.process_index + 1) * mesh.local_rows)
    step(torch.from_numpy(mix[rows]).to(mesh.first),
         torch.from_numpy(target[rows]).to(mesh.first))
    leaves = flatten_tree(export_jax_params(model)).values()
    return float(sum(np.abs(v).astype(np.float64).sum() for v in leaves))


def main() -> int:
    handles = os.environ.get("AUDSEP_DRYRUN_CPU_HANDLES")
    devices = [torch.device("cpu")] * int(handles) if handles else None
    joined = init_distributed_from_env(backend="gloo" if handles else "nccl")
    mesh = make_mesh(tp=int(os.environ.get("AUDSEP_DRYRUN_TP", "2")), devices=devices)
    dp, tp = mesh.shape["data"], mesh.shape["model"]

    # The process's blocks of a globally sharded array: rows of its data rows,
    # every column block of the model axis.
    global_shape = (dp * 8, tp * 16)
    row0 = mesh.process_index * mesh.local_rows * 8
    rows = np.arange(row0, row0 + mesh.local_rows * 8, dtype=np.float64)
    cols = np.arange(global_shape[1], dtype=np.float64)
    local = torch.tensor((rows[:, None] * 1000.0 + cols[None, :]).sum(), dtype=torch.float64,
                         device=mesh.first)
    if joined:
        import torch.distributed as dist

        dist.all_reduce(local)
    got = float(local)
    all_rows = np.arange(global_shape[0], dtype=np.float64)
    want = float((all_rows[:, None] * 1000.0 + cols[None, :]).sum())
    checksum = sgd_checksum(mesh)

    ok = abs(got - want) < 1e-3 * max(1.0, abs(want)) and np.isfinite(checksum)
    print(json.dumps({
        "ok": bool(ok),
        "joined_cluster": bool(joined),
        "process": mesh.process_index,
        "num_processes": mesh.process_count,
        "devices_global": dp * tp,
        "devices_local": int(mesh.devices.size),
        "mesh": mesh.shape,
        "sum": got,
        "want": want,
        "checksum": checksum,
    }), flush=True)
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
