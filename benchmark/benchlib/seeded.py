"""Everything a run makes from ``--seed``: seeded random streams, weights
made on the device in one draw, and the WAV inputs.

Streams are named (``stream(seed, "weights")``), so the weights, the songs
and the batches of one seed are independent of each other and the same in
every run of that seed. Seeds may exceed 32 bits.
"""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np
import torch


def stream(seed: int, tag: str) -> int:
    """A 63-bit seed for the named stream of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, tag))
    return g


def numpy_rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(stream(seed, tag))


def seeded_state(module: torch.nn.Module, seed: int, device, rule) -> dict:
    """A state dict with ``module``'s keys and shapes, drawn on ``device`` in
    one call from the seed's weight stream; ``rule(key, shape)`` gives each
    leaf's ``("fill", value)`` or ``("scale", factor)`` of unit normals."""
    shapes = [(k, tuple(v.shape)) for k, v in module.state_dict().items()]
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    state, off = {}, 0
    for key, shape in shapes:
        n = math.prod(shape)
        leaf = flat[off : off + n].view(shape)
        off += n
        how, value = rule(key, shape)
        if how == "fill":
            leaf.fill_(value)
        else:
            leaf.mul_(value)
        state[key] = leaf
    return {k: v.clone() for k, v in state.items()}  # leaves of their own


def fan_in_rule(key: str, shape: tuple, transposed: bool = False) -> tuple:
    """N(0, 1/fan_in) for products and convolutions (the fan-in is every axis
    but the output channels: axis 1 of a transposed convolution), 0.02 · N
    for biases, 1 for one-axis gains."""
    leaf = key.rsplit(".", 1)[-1]
    if "bias" in leaf:
        return "scale", 0.02
    if len(shape) == 1:
        return "fill", 1.0
    out_axis = 1 if transposed else 0
    return "scale", 1.0 / math.sqrt(math.prod(shape) // shape[out_axis])


def balanced_order(count: int, seed: int) -> list:
    """The indices of ``count`` lengths sorted ascending, shortest and
    longest in turn (0, n−1, 1, n−2, ...), rotated by a seeded offset: every
    seed's order, and any stretch of it, holds about the same audio."""
    pairs = [i for k in range(count // 2) for i in (k, count - 1 - k)]
    if count % 2:
        pairs.append(count // 2)
    r = int(numpy_rng(seed, "order").integers(count))
    return pairs[r:] + pairs[:r]


def write_songs(directory: str, seed: int, lengths_s, rate: int, device) -> list:
    """16-bit stereo WAV files of the given lengths, in the seed's balanced
    order, each two sines of seeded pitch under seeded noise, made on the
    device. Returns ``[(path, seconds)]``."""
    from reference.separate import write_wav

    rng = numpy_rng(seed, "songs")
    lengths_s = sorted(lengths_s)
    order = balanced_order(len(lengths_s), seed)
    g = generator(seed, "song-noise", device)
    songs = []
    os.makedirs(directory, exist_ok=True)
    for i, idx in enumerate(order):
        n = int(round(float(lengths_s[idx]) * rate))
        f1, f2 = rng.uniform(110.0, 440.0, size=2)
        t = torch.arange(n, device=device, dtype=torch.float64) / rate
        tone = torch.stack([torch.sin(2 * math.pi * f1 * t), torch.sin(2 * math.pi * f2 * t)])
        pcm = 0.25 * tone.float() + 0.05 * torch.randn((2, n), generator=g, device=device)
        path = os.path.join(directory, f"song{i:02d}.wav")
        write_wav(path, pcm.cpu().numpy(), rate)
        songs.append((path, n / rate))
    return songs


def spread(lo: float, hi: float, count: int) -> list:
    """``count`` lengths evenly spread over ``[lo, hi]``: every seed gets
    this same set, in its own order."""
    return [lo + (hi - lo) * (i + 0.5) / count for i in range(count)]
