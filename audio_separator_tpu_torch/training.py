"""Fine-tuning: one training step for the RoFormer family (BS and Mel),
HTDemucs and HDemucs.

Port of ``audio_separator_tpu/training.py`` in PyTorch's idiom: the step
runs the module's forward, the loss, ``backward()`` and the optimiser's
update in place. The RoFormer family trains on the upstream L1 + multi-
resolution STFT objective (``ops/losses.roformer_training_loss``), HTDemucs
and HDemucs on time-domain L1 over the stems (the demucs recipe).

On the card the RoFormer blocks and the HTDemucs self-attention run their
hand-written kernels forward and backward (``ops/attention_block.py``,
``ops/attention.py``, ``ops/block_backward.py``); on the CPU their plain
versions, in the same composition. Nothing falls back: a CUDA step that
cannot build or launch a kernel raises.

Typical use (``tools/finetune_torch.py`` is a runnable loop)::

    model = load_jax_params(Roformer(cfg), tree).to("cuda")
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_train_step(cfg, model, opt)
    for mix, target in batches:        # (B, C, T), (B, S, C, T) on the card
        loss = step(mix, target)

Sharded (``parallel/mesh.py``): lay the module out for the mesh first, then
build the optimizer over the laid-out module's parameters, the master copy::

    mesh = make_mesh(tp=2)                      # (dp, tp) over the local cards
    model = shard_model(model, mesh)            # Megatron shards on each row's devices
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    step = make_train_step(cfg, model, opt, mesh=mesh)

Each step splits the batch over the mesh's local rows. Row 0 runs the module
itself; another row whose devices differ runs it on copies of the parameters
made inside the step on that row's devices (``parallel.mesh.call_on_row``),
so autograd sums every row's gradients onto the master. Each row's loss is
weighted by its share of the batch, so the step's loss is the mean over the
whole batch and the sharded step equals the replicated one. Over a process
group (``parallel.mesh.init_distributed_from_env``) the gradients and the
loss are then averaged over the processes with ``all_reduce`` (each process
passes its own, equally large, part of the global batch), before the
optimizer's update. Tensor parallelism stays inside a process.
``models/convert.export_jax_params`` gathers the shards back into the full
tree.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .models.roformer import RoformerConfig
from .ops.fn_cache import is_shared
from .parallel.mesh import call_on_row
from .ops.losses import DEFAULT_RESOLUTIONS, roformer_training_loss
from .ops.precision import full_float32

__all__ = ["make_loss_fn", "make_train_step"]


def make_loss_fn(cfg, model: torch.nn.Module, stft_n_fft: int = 2048,
                 window_sizes: Sequence[int] = DEFAULT_RESOLUTIONS, hop_length: int = 147,
                 multi_stft_weight: float = 1.0
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``loss(mix (B, C, T), target (B, S, C, T)) -> scalar``: the model's
    forward, its output cut to the target's length, and the family's loss.
    ``window_sizes`` must each be at most the segment length (shrink them for
    short synthetic segments); HTDemucs and HDemucs ignore the STFT-loss
    arguments. ``model`` may be any callable of ``mix``."""
    if isinstance(cfg, RoformerConfig):
        def loss(mix, target):
            out = model(mix)[..., : target.shape[-1]]
            total, _ = roformer_training_loss(
                out, target, stft_n_fft=stft_n_fft, window_sizes=window_sizes,
                hop_length=hop_length, multi_stft_weight=multi_stft_weight)
            return total
    else:
        def loss(mix, target):
            out = model(mix)[..., : target.shape[-1]]
            return (out - target).abs().mean()
    return loss


def _all_reduce_mean(tensors) -> None:
    """Average ``tensors`` in place over the process group."""
    import torch.distributed as dist

    world = dist.get_world_size()
    for t in tensors:
        dist.all_reduce(t)
        t.div_(world)


def make_train_step(cfg, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    mesh=None, compute_dtype: torch.dtype = torch.float32,
                    stft_n_fft: int = 2048,
                    window_sizes: Sequence[int] = DEFAULT_RESOLUTIONS,
                    hop_length: int = 147, multi_stft_weight: float = 1.0
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``step(mix, target) -> loss`` for ``cfg`` (``RoformerConfig`` or
    ``HTDemucsConfig``, HTDemucs or HDemucs by ``cfg.arch``) and its
    ``model``, updated in place by ``optimizer``, which the caller built over
    ``model.parameters()``. The step runs on the model's and the tensors'
    device and returns the loss before the update, detached.

    ``mesh``: a ``parallel.mesh.Mesh`` that ``model`` was laid out for
    (``parallel.mesh.shard_model``, before the optimizer was built); the
    batch, whose size the local rows must divide, is split over its data
    axis (the module docstring).

    The whole step runs inside one ``ops/precision.full_float32`` scope:
    forward, loss, ``backward()`` and ``optimizer.step()``, so the backward
    passes of convolutions and products stay float32 whatever the process's
    TF32 switches say. The model's parameters are made to require gradients
    and the model is put in training mode (cuDNN's LSTM has a backward pass
    only there; no module of these families computes otherwise in it).

    A module that a ``Separator`` loaded is shared process-wide by the model
    cache (``ops/fn_cache``) and is refused: training changes it in place.
    Train a module of its own, e.g. ``copy.deepcopy(sep.model_instance.model)``
    or one built from the checkpoint."""
    if mesh is not None and getattr(model, "mesh", None) is not mesh:
        raise ValueError("make_train_step(mesh=...): lay the module out for the mesh first "
                         "(parallel.mesh.shard_model(model, mesh)) and build the optimizer "
                         "over the result's parameters")
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"make_train_step(compute_dtype={compute_dtype}): training is float32 only; "
            f"bf16 training (bf16 backward kernels, float32 master weights) is ROADMAP "
            f"item 17b")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise NotImplementedError("training takes a float32 model (bf16 training is "
                                  "ROADMAP item 17b)")
    if is_shared(model):
        raise ValueError("make_train_step: this module is shared by the process's model cache "
                         "(ops/fn_cache) and serves every Separator of its checkpoint; train "
                         "a copy (copy.deepcopy) or a module built for training")
    model.requires_grad_(True)
    model.train()
    loss_fn = make_loss_fn(cfg, model, stft_n_fft=stft_n_fft, window_sizes=window_sizes,
                           hop_length=hop_length, multi_stft_weight=multi_stft_weight)

    def step(mix: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        with full_float32():
            optimizer.zero_grad(set_to_none=True)
            if mesh is None:
                loss = loss_fn(mix, target)
                loss.backward()
            else:
                loss = _sharded_backward(mix, target)
            optimizer.step()
        return loss.detach()

    def _sharded_backward(mix: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        rows = mesh.row_devices()
        if mix.shape[0] % len(rows):
            raise ValueError(f"a batch of {mix.shape[0]} does not split over "
                             f"{len(rows)} data rows")
        loss = torch.zeros((), device=mesh.first)
        for r, (m, t) in enumerate(zip(mix.chunk(len(rows)), target.chunk(len(rows)))):
            row_loss = make_loss_fn(
                cfg, lambda x, r=r: call_on_row(model, mesh, r, x), stft_n_fft=stft_n_fft,
                window_sizes=window_sizes, hop_length=hop_length,
                multi_stft_weight=multi_stft_weight)(m.to(rows[r]), t.to(rows[r]))
            row_loss = row_loss * (m.shape[0] / mix.shape[0])
            row_loss.backward()  # each row's graph is freed before the next is built
            loss = loss + row_loss.detach().to(mesh.first)
        if mesh.process_count > 1:
            params = list(model.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _all_reduce_mean([loss] + [p.grad for p in params])
        return loss

    return step
