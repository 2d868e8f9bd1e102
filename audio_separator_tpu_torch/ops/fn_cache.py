"""Process-wide cache of loaded models: one built module, with its weights on
the device, per checkpoint, device, compute type and configuration, shared by
every ``Separator`` of the process.

The counterpart of the JAX package's device-resident parameter cache
(``audio_separator_tpu/ops/fn_cache.py``: ``file_key``,
``memoized_device_params``). Serving builds a fresh ``Separator`` per job, and
an ensemble loads each member at every ``separate``: without this cache every
one of them read its checkpoint, converted it, built the module and uploaded
the weights again, most of a first RoFormer call's time on the card. The JAX
package's other two caches, of jitted model functions, have no counterpart:
PyTorch runs eagerly.

The cache is a bounded LRU (8 entries: a Demucs bag takes one per member
file). An evicted module is freed once no live separator holds it. Unlike the
JAX cache, which builds outside its lock and keeps the first value when two
threads race, a key's build runs under a lock of its own, so two threads that
ask for one model build it once: a RoFormer's 3xTF32 weight forms (0.6 GB on
the card for the flagship) are made once, inside the build.

Cached modules are shared and run in inference mode; ``training.make_train_step``
refuses them (:func:`is_shared`), since it switches gradients on in place.
:func:`clear` drops every entry, e.g. to free the card for training.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable

import torch

MAX_ENTRIES = 8
_cache: "OrderedDict[Hashable, Any]" = OrderedDict()
_lock = threading.Lock()
_building: Dict[Hashable, threading.Lock] = {}
_shared: "weakref.WeakSet[torch.nn.Module]" = weakref.WeakSet()


def file_key(path: str) -> tuple:
    """``(abspath, size, mtime in ns)``: a cheap content identity for a
    checkpoint; rewriting or touching the file changes it."""
    st = os.stat(path)
    return (os.path.abspath(path), st.st_size, st.st_mtime_ns)


def _modules_of(value: Any):
    if isinstance(value, torch.nn.Module):
        yield value
    elif isinstance(value, (tuple, list)):
        for item in value:
            yield from _modules_of(item)


def memoized_model(key: Hashable, make: Callable[[], Any]) -> Any:
    """The process-wide value for ``key``, built by ``make()`` on a miss.
    Concurrent callers with one key wait for one build; every module in the
    value (itself, or inside a tuple or list) is marked shared."""
    with _lock:
        if key in _cache:
            _cache.move_to_end(key)
            return _cache[key]
        key_lock = _building.setdefault(key, threading.Lock())
    with key_lock:
        with _lock:
            if key in _cache:  # built while this thread waited
                _cache.move_to_end(key)
                return _cache[key]
        try:
            value = make()
        except BaseException:
            with _lock:
                _building.pop(key, None)
            raise
        with _lock:
            for module in _modules_of(value):
                _shared.add(module)
            _cache[key] = value
            while len(_cache) > MAX_ENTRIES:
                _cache.popitem(last=False)
            _building.pop(key, None)
    return value


def is_shared(module: torch.nn.Module) -> bool:
    """Whether ``module`` came from the cache (and may be in use elsewhere)."""
    return module in _shared


def cached_keys() -> list:
    """The keys held, least recently used first."""
    with _lock:
        return list(_cache)


def clear() -> int:
    """Drop every entry; returns how many there were. The modules are freed
    once no separator holds them (``torch.cuda.empty_cache()`` then returns
    their memory to the card)."""
    with _lock:
        count = len(_cache)
        _cache.clear()
    return count
