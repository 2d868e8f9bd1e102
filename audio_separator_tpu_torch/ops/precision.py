"""Precision scopes shared by the port's models and its training step.

cuDNN allows TF32 for float32 convolutions by default, and TF32 keeps about
three decimal digits: a float32 model that must match the JAX package's
float32 numerics runs its convolutions and cuBLAS products under
:func:`full_float32`. HTDemucs, HDemucs, TFC-TDF (MDX23C), MDX, VR, the LSTM,
Wiener filtering and the resampler use it.

cuBLAS may also reduce bf16 products in reduced precision (PyTorch's
``allow_bf16_reduced_precision_reduction``, on by default), where the JAX
package's bf16 products accumulate in float32: the bf16 training step and
the bf16 backward passes of the RoFormer blocks run under
:func:`float32_bf16_reductions`.
"""

from __future__ import annotations

import contextlib
import threading

import torch


class _ProcessScope:
    """Process-wide ``torch.backends`` switches held at ``held`` while any
    thread is inside one of the scopes: the number of scopes open in every
    thread is counted under a lock; the first to enter saves the switches and
    sets them, the last to leave restores them."""

    def __init__(self, read, write, held):
        self._read, self._write, self._held = read, write, held
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def scope(self):
        with self._lock:
            if self._depth == 0:
                self._saved = self._read()
                self._write(self._held)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._write(self._saved)
                    self._saved = None


def _set_tf32(values) -> None:
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = values


def _set_bf16_reduction(value) -> None:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = value


_TF32_OFF = _ProcessScope(
    lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32),
    _set_tf32, (False, False))
_BF16_REDUCTION_OFF = _ProcessScope(
    lambda: torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
    _set_bf16_reduction, False)


def full_float32():
    """Keep cuDNN convolutions and cuBLAS products of the enclosed float32
    work in full float32, whatever the process-wide TF32 switches say (cuDNN
    allows TF32 by default; it keeps about three decimal digits).

    The two switches (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32``) belong to the process, not to a
    thread, and a server runs jobs on several threads. So the scope counts the
    scopes open in every thread: the first to enter saves both switches and
    clears them, the last to leave restores them, and while any thread is
    inside, both read ``False``. The scope only ever moves the switches toward
    full float32. Holding them off for a while after one thread has left
    changes no other float32 work of the port: none depends on TF32 being on
    (VR's ``Conv2d`` runs PyTorch's im2col + GEMM, and the matmul switch is
    off by PyTorch's default)."""
    return _TF32_OFF.scope()


def float32_bf16_reductions():
    """Keep the reductions of the enclosed cuBLAS bf16 products in float32
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off), as the JAX package's bf16 products accumulate. Counted across
    threads as :func:`full_float32` is; it only ever moves the switch toward
    float32 reductions."""
    return _BF16_REDUCTION_OFF.scope()
