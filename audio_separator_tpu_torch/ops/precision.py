"""Precision scopes shared by the port's float32 models.

cuDNN allows TF32 for float32 convolutions by default, and TF32 keeps about
three decimal digits: a float32 model that must match the JAX package's
float32 numerics runs its convolutions and cuBLAS products under
:func:`full_float32`. HTDemucs, HDemucs, TFC-TDF (MDX23C), MDX, VR, the LSTM,
Wiener filtering and the resampler use it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# The process-wide state behind full_float32: the number of scopes open in
# any thread, and the switches saved by the first of them.
_lock = threading.Lock()
_depth = 0
_saved = None


@contextlib.contextmanager
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
    global _depth, _saved
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _lock:
        if _depth == 0:
            _saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _saved
                _saved = None
