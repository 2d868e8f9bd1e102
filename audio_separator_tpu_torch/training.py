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
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .models.roformer import RoformerConfig
from .ops.fn_cache import is_shared
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
    arguments."""
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
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): sharded training needs the device mesh, "
            "ROADMAP item 16, which the port does not have yet")
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
            loss = loss_fn(mix, target)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step
