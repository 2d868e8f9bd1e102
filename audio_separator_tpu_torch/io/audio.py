"""Host-side audio I/O.

Decode, encode and resampling run on the host CPU through the package's own
native codec (``io/codec.cpp``, linked against libavformat, libavcodec,
libavutil and libswresample), with the JAX package's dispatch rule:

* ``AUDSEP_CODEC_SUBPROCESS`` set: every decode and probe, and every non-WAV
  encode, runs the codec as a child process (``-DAUDSEP_CLI`` build), which
  keeps libav's heap out of this process;
* otherwise the codec is a shared library loaded with ``ctypes``;
* where neither can be built or loaded (no compiler, no libav headers or
  libraries), the pure-Python WAV path: WAV only, resampling with
  ``scipy.signal.resample_poly``, and ``save_audio`` of another format raises.

WAV is written without libav, by the package's WAV writer (``io/wav.cpp``,
loaded with ``ctypes``): one pass reads the stem's peak, and one more scales,
clips, quantises and interleaves it into the file's buffer, which is written
with a single ``write``; where that cannot be built, the numpy writer
(``_save_wav``) writes the same bytes. Both native libraries are compiled
with ``g++`` at first use into ``build/torch_codec/`` at the repository root,
keyed on a hash of the source and flags. The first call logs which route was
taken. :data:`ENCODES` counts encodes by route.

PCM exchanged with the rest of the package is float32 ``(channels,
samples)``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import tempfile
import threading
import wave
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..ops.resample import resample_poly_np
from ..ops.spec import normalize, peak_scale
from ..utils.tracing import span

_HERE = os.path.dirname(os.path.abspath(__file__))
CODEC_SOURCE = os.path.join(_HERE, "codec.cpp")
WAV_SOURCE = os.path.join(_HERE, "wav.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "torch_codec")
GXX_FLAGS = ("-O2", "-std=c++17")
_AV_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")
# The WAV writer's arithmetic must be numpy's to the bit: no contraction of a
# product into an add, no fast-math. -fno-trapping-math only stops the
# compiler from keeping floating-point exception flags exact, which lets it
# vectorise the clip and the conversion to integers; no value changes.
WAV_GXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-fno-trapping-math")
# artifact -> (file name stem, source, g++ flags, libraries)
_ARTIFACTS = {"library": ("libaudsep_codec", CODEC_SOURCE, GXX_FLAGS + ("-fPIC", "-shared"),
                          _AV_LIBS),
              "cli": ("audsep_codec", CODEC_SOURCE, GXX_FLAGS + ("-DAUDSEP_CLI",), _AV_LIBS),
              "wav": ("libaudsep_wav", WAV_SOURCE, WAV_GXX_FLAGS + ("-fPIC", "-shared"), ())}
# The 44 bytes before a WAV file's samples, as the ``wave`` module writes them.
_WAV_HEADER = struct.Struct("<4sI4s4sIHHIIHH4sI")

# Encodes by route: "wav_native", "wav_python", "library", "subprocess".
ENCODES: collections.Counter = collections.Counter()
_encodes_lock = threading.Lock()

_logger = logging.getLogger(__name__)
_lock = threading.Lock()
_lib = None
_lib_error: Optional[str] = None
_cli: Optional[str] = None
_cli_error: Optional[str] = None
_wav_lib = None
_wav_error: Optional[str] = None
_routes_logged: set = set()


@dataclass
class AudioInfo:
    sample_rate: int
    channels: int
    frames: int  # -1 if unknown
    bits_per_sample: int


# ---------------------------------------------------------------------------
# Building and loading the codec.

def codec_path(artifact: str) -> str:
    """Where the codec's ``"library"`` or ``"cli"`` build, or the WAV
    writer's ``"wav"`` build, lives for this source and these flags."""
    stem, source, flags, libs = _ARTIFACTS[artifact]
    h = hashlib.sha256(" ".join(flags + libs).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    suffix = "" if artifact == "cli" else ".so"
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}{suffix}")


def _build(artifact: str) -> str:
    """Compile ``artifact`` unless it is built already. The output is written
    under a temporary name and renamed into place, so concurrent processes
    never load a partial file. Raises ``RuntimeError`` when g++ fails."""
    out = codec_path(artifact)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    _, source, flags, libs = _ARTIFACTS[artifact]
    cmd = ["g++", *flags, source, *libs, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"g++ could not run: {exc}") from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        tail = proc.stderr.strip().splitlines()[-1:] or [f"exit {proc.returncode}"]
        raise RuntimeError(f"g++ failed for the {artifact} build: {tail[0]}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build("library"))
        except (RuntimeError, OSError) as exc:  # no g++, no libav, or libav missing at run time
            _lib_error = str(exc)
            return None
        lib.as_last_error.restype = ctypes.c_char_p
        lib.as_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.as_decode.restype = ctypes.c_int
        lib.as_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
        ]
        lib.as_probe.restype = ctypes.c_int
        lib.as_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.as_encode.restype = ctypes.c_int
        lib.as_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.as_free.restype = None
        _lib = lib
        return _lib


def _codec_cli() -> Optional[str]:
    global _cli, _cli_error
    with _lock:
        if _cli is None and _cli_error is None:
            try:
                _cli = _build("cli")
            except RuntimeError as exc:
                _cli_error = str(exc)
        return _cli


def _load_wav_lib():
    """The WAV writer's library, or None where it cannot be built or
    loaded (then ``_wav_error`` says why)."""
    global _wav_lib, _wav_error
    with _lock:
        if _wav_lib is not None or _wav_error is not None:
            return _wav_lib
        try:
            lib = ctypes.CDLL(_build("wav"))
        except (RuntimeError, OSError) as exc:  # no g++
            _wav_error = str(exc)
            return None
        view = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.aw_peak.argtypes = view
        lib.aw_peak.restype = ctypes.c_float
        lib.aw_encode.argtypes = view + [ctypes.c_int, ctypes.c_double, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.aw_encode.restype = None
        _wav_lib = lib
        return _wav_lib


def native_codec_available() -> bool:
    return _load_lib() is not None


def _log_route(route: str, detail) -> None:
    """Log ``route`` with ``detail()`` the first time it is taken."""
    if route not in _routes_logged:
        _routes_logged.add(route)
        _logger.info(f"audio I/O route: {route} ({detail()})")


def _count(route: str) -> None:
    with _encodes_lock:
        ENCODES[route] += 1


def _route() -> str:
    """``"subprocess"``, ``"library"`` or ``"wav"``: the JAX package's rule.
    Logs each route the first time it is taken."""
    if os.environ.get("AUDSEP_CODEC_SUBPROCESS") and _codec_cli() is not None:
        route = "subprocess"
    elif _load_lib() is not None:
        route = "library"
    else:
        route = "wav"
    _log_route(route, lambda: {"subprocess": _cli, "library": codec_path("library"),
                               "wav": f"native codec unavailable: {_lib_error}"}[route])
    return route


# ---------------------------------------------------------------------------
# The codec as a child process.

def _run_cli(args, what: str, path: str) -> str:
    out = subprocess.run([_codec_cli(), *args], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{what} failed for {path}: {out.stderr.strip()}")
    return out.stdout


def _probe_subprocess(path: str) -> AudioInfo:
    sr, ch, frames, bits = _run_cli(["probe", path], "probe", path).split()
    return AudioInfo(int(sr), int(ch), int(frames), int(bits))


def _load_subprocess(path: str, sample_rate, channels):
    with tempfile.NamedTemporaryFile(suffix=".raw", delete=False) as tf:
        raw = tf.name
    try:
        _run_cli(["decode", path, str(sample_rate or 0), str(channels or 0), raw],
                 "decode", path)
        with open(raw, "rb") as f:
            header = np.fromfile(f, dtype=np.int64, count=1)
            meta = np.fromfile(f, dtype=np.int32, count=2)
            frames, ch, sr = int(header[0]), int(meta[0]), int(meta[1])
            data = np.fromfile(f, dtype=np.float32, count=frames * ch)
        return np.ascontiguousarray(data.reshape(frames, ch).T), sr
    finally:
        os.unlink(raw)


def _save_subprocess(path: str, interleaved: np.ndarray, sample_rate: int,
                     fmt: str, bit_depth: int, bitrate_kbps: int) -> None:
    with tempfile.NamedTemporaryFile(suffix=".raw", delete=False) as tf:
        raw = tf.name
        interleaved.astype("<f4").tofile(tf)
    try:
        _run_cli(["encode", path, raw, str(interleaved.shape[0]), str(interleaved.shape[1]),
                  str(sample_rate), fmt, str(bit_depth), str(bitrate_kbps)], "encode", path)
    finally:
        os.unlink(raw)


# ---------------------------------------------------------------------------
# The public entry points.

def probe(path: str) -> AudioInfo:
    """Stream properties without decoding the samples."""
    route = _route()
    if route == "subprocess":
        return _probe_subprocess(path)
    if route == "wav":
        return _probe_wav(path)
    sr, ch, fr, bits = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    rc = _lib.as_probe(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                       ctypes.byref(fr), ctypes.byref(bits))
    if rc != 0:
        raise RuntimeError(f"probe failed for {path}: {_lib.as_last_error().decode()}")
    return AudioInfo(sr.value, ch.value, fr.value, bits.value)


def load_audio(path: str, sample_rate: Optional[int] = None,
               channels: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Decode to float32 ``(channels, samples)``, optionally resampled and
    up/down-mixed (inside libswresample on the codec routes). Returns
    ``(pcm, sample_rate)``."""
    with span("audio.decode"):
        route = _route()
        if route == "subprocess":
            return _load_subprocess(path, sample_rate, channels)
        if route == "wav":
            return _load_wav(path, sample_rate, channels)
        data = ctypes.POINTER(ctypes.c_float)()
        frames, ch, sr = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
        rc = _lib.as_decode(path.encode(), sample_rate or 0, channels or 0, ctypes.byref(data),
                            ctypes.byref(frames), ctypes.byref(ch), ctypes.byref(sr))
        if rc != 0:
            raise RuntimeError(f"decode failed for {path}: {_lib.as_last_error().decode()}")
        try:
            arr = np.ctypeslib.as_array(data, shape=(frames.value * ch.value,)).copy()
        finally:
            _lib.as_free(data)
        return np.ascontiguousarray(arr.reshape(frames.value, ch.value).T), sr.value


def save_audio(path: str, pcm: np.ndarray, sample_rate: int,
               output_format: Optional[str] = None, bit_depth: int = 16,
               bitrate_kbps: int = 0, *, max_peak: Optional[float] = None,
               min_peak: Optional[float] = None):
    """Encode ``(channels, samples)`` PCM (float32, or any type numpy casts
    to it; any strides) to ``path``. The format is the extension's unless
    given; WAV, FLAC and AIFF keep ``bit_depth`` (16, 24, or 32 = IEEE float
    for WAV); ``bitrate_kbps`` sets lossy formats' rate.

    With ``max_peak`` the PCM is first normalised as
    ``ops.spec.normalize(pcm, max_peak, min_peak)`` does it, and the peak
    |sample| after that, a numpy scalar of the PCM's type, is returned
    (otherwise None). A float32 WAV stem is normalised inside the
    writer's pass, to the same bytes."""
    with span("audio.encode") as record:
        if pcm.ndim == 1:
            pcm = pcm[None, :]
        fmt = (output_format or os.path.splitext(path)[1].lstrip(".") or "wav").lower()
        route = _encode_route(fmt, pcm)
        if record is not None:
            record.attrs["route"] = route
        _count(route)
        if route == "wav_native":
            return _save_wav_native(path, pcm, sample_rate, bit_depth, max_peak, min_peak)
        peak = None
        if max_peak is not None:
            pcm = normalize(pcm, max_peak, min_peak)
            peak = np.abs(pcm).max()
        interleaved = np.ascontiguousarray(pcm.T, dtype=np.float32)
        if route == "wav_python":
            _save_wav(path, interleaved, sample_rate, bit_depth)
        elif route == "subprocess":
            _save_subprocess(path, interleaved, sample_rate, fmt, bit_depth, bitrate_kbps)
        else:
            ptr = interleaved.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            rc = _lib.as_encode(path.encode(), ptr, interleaved.shape[0], interleaved.shape[1],
                                sample_rate, fmt.encode(), bit_depth, bitrate_kbps)
            if rc != 0:
                raise RuntimeError(f"encode failed for {path}: {_lib.as_last_error().decode()}")
        return peak


def _encode_route(fmt: str, pcm: np.ndarray) -> str:
    """``"wav_native"`` or ``"wav_python"`` for WAV (the numpy writer where
    the WAV writer cannot be built, and for PCM without channels), else the
    codec's route; raises where no route encodes ``fmt``."""
    if fmt == "wav":
        if pcm.shape[0] and _load_wav_lib() is not None:
            _log_route("wav_native", lambda: codec_path("wav"))
            return "wav_native"
        _log_route("wav_python", lambda: f"WAV writer unavailable: {_wav_error}")
        return "wav_python"
    route = _route()
    if route == "wav":
        raise RuntimeError(f"cannot encode '{fmt}': native codec unavailable ({_lib_error}); "
                           f"only WAV is written without it")
    return route


def _save_wav_native(path: str, pcm: np.ndarray, sample_rate: int, bit_depth: int,
                     max_peak: Optional[float], min_peak: Optional[float]):
    """``save_audio``'s WAV route through ``io/wav.cpp``: the bytes of
    ``_save_wav`` on ``normalize``'s output. Float32 PCM is read in place and
    scaled inside the pass by ``normalize``'s factor, from the peak the
    library finds; other types are normalised in numpy first and cast, in the
    order of the numpy route."""
    peak = None
    if max_peak is not None and not (_native_type(pcm) and pcm.size):
        pcm = normalize(pcm, max_peak, min_peak)
        peak, max_peak = np.abs(pcm).max(), None
    if not _native_type(pcm):
        pcm = pcm.astype(np.float32)
    channels, frames = pcm.shape
    cs, fs = (stride // pcm.itemsize for stride in pcm.strides)
    scale = None
    if max_peak is not None:
        top = np.float32(_wav_lib.aw_peak(pcm.ctypes.data, channels, frames, cs, fs))
        scale = peak_scale(top, max_peak, min_peak)
        # numpy multiplies a float32 array by the factor narrowed to float32.
        peak = top if scale is None else abs(top * np.float32(scale))
    width = 4 if bit_depth >= 32 else 3 if bit_depth == 24 else 2
    size = channels * frames * width
    buf = np.empty(_WAV_HEADER.size + size, np.uint8)
    _WAV_HEADER.pack_into(buf, 0, b"RIFF", 36 + size, b"WAVE", b"fmt ", 16,
                          3 if width == 4 else 1, channels, sample_rate,
                          sample_rate * channels * width, channels * width, width * 8,
                          b"data", size)
    _wav_lib.aw_encode(pcm.ctypes.data, channels, frames, cs, fs, scale is not None,
                       0.0 if scale is None else float(scale), width,
                       buf.ctypes.data + _WAV_HEADER.size)
    with open(path, "wb") as f:
        f.write(memoryview(buf))
    return peak


def _native_type(pcm: np.ndarray) -> bool:
    """Whether the WAV writer reads ``pcm`` in place: float32 samples on
    whole-element, aligned strides."""
    return (pcm.dtype == np.float32 and pcm.dtype.isnative
            and pcm.flags.aligned and all(s % pcm.itemsize == 0 for s in pcm.strides))


# ---------------------------------------------------------------------------
# The pure-Python WAV path.

def _require_wav(path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext not in ("", ".wav", ".wave"):
        raise ValueError(
            f"{path}: only WAV is read without the native codec "
            f"(unavailable here: {_lib_error})")


def _save_wav(path: str, interleaved: np.ndarray, sample_rate: int, bit_depth: int):
    frames, channels = interleaved.shape
    clipped = np.clip(interleaved, -1.0, 1.0)
    if bit_depth >= 32:
        _save_wav_float32(path, clipped, sample_rate)
        return
    if bit_depth == 24:
        ints = (clipped * 8388607.0).round().astype("<i4").reshape(-1)
        raw = ints.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        sampwidth = 3
    else:
        raw = (clipped * 32767.0).round().astype("<i2").tobytes()
        sampwidth = 2
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sampwidth)
        w.setframerate(sample_rate)
        w.writeframes(raw)


def _save_wav_float32(path: str, interleaved: np.ndarray, sample_rate: int):
    frames, channels = interleaved.shape
    data = interleaved.astype("<f4").tobytes()
    byte_rate = sample_rate * channels * 4
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 3, channels, sample_rate, byte_rate,
                            channels * 4, 32))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def _parse_riff(path: str):
    """Minimal RIFF/WAVE parser for what the stdlib ``wave`` module rejects
    (IEEE float, WAVE_FORMAT_EXTENSIBLE). Returns (format_code, channels,
    sample_rate, bits, data)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise RuntimeError(f"not a RIFF/WAVE file: {path}")
    pos, fmt, payload = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise RuntimeError(f"missing fmt/data chunk in {path}")
    code, ch, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if code == 0xFFFE and len(fmt) >= 40:
        code = struct.unpack("<H", fmt[24:26])[0]
    return code, ch, sr, bits, payload


def _load_wav(path: str, sample_rate, channels):
    _require_wav(path)
    try:
        with wave.open(path, "rb") as w:
            ch, sw, sr, n = (w.getnchannels(), w.getsampwidth(),
                             w.getframerate(), w.getnframes())
            raw = w.readframes(n)
        code = 1
    except wave.Error:
        code, ch, sr, bits, raw = _parse_riff(path)
        sw = bits // 8
    if code == 3:  # IEEE float
        x = np.frombuffer(raw, dtype="<f4" if sw == 4 else "<f8").astype(np.float32)
    elif sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = (x << 8 >> 8).astype(np.float32) / 8388608.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise RuntimeError(f"unsupported WAV sample width {sw}")
    pcm = x.reshape(-1, ch).T
    if channels and channels != ch:
        if channels == 2 and ch == 1:
            pcm = np.vstack([pcm, pcm])
        elif channels == 1:
            pcm = pcm.mean(axis=0, keepdims=True)
    if sample_rate and sample_rate != sr:
        pcm = resample_poly_np(pcm, sr, sample_rate)
        sr = sample_rate
    return np.ascontiguousarray(pcm.astype(np.float32)), sr


def _probe_wav(path: str) -> AudioInfo:
    _require_wav(path)
    try:
        with wave.open(path, "rb") as w:
            return AudioInfo(w.getframerate(), w.getnchannels(), w.getnframes(),
                             w.getsampwidth() * 8)
    except wave.Error:
        code, ch, sr, bits, payload = _parse_riff(path)
        return AudioInfo(sr, ch, len(payload) // max(1, ch * bits // 8), bits)
