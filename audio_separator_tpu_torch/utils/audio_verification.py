"""Stem-content verification: correlate outputs against known-good stems.

The port's own copy of ``audio_separator_tpu/utils/audio_verification.py``,
over the port's ``io/audio``. A port of the reference's regression-test
classifier (ref: tests/utils_audio_verification.py:28-120): classifies a stem
as VOCALS / INSTRUMENTAL / FULL_MIX / SILENT / UNCLEAR by correlation against
reference separations, and checks the label matches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..io import audio as audio_io


@dataclass
class StemVerification:
    file_path: str
    label: str
    corr_vocal: float
    corr_instrumental: float
    corr_mix: float
    rms: float
    detected_content: str
    label_matches: bool


def _load_mono(path: str, sr: int = 44100) -> np.ndarray:
    pcm, _ = audio_io.load_audio(path, sample_rate=sr)
    return pcm.mean(axis=0)


def load_references(input_dir: str = "tests/inputs", sr: int = 44100):
    """Load known-good reference stems + mix → (vocal, inst, mix, min_len)."""
    ref_vocal = _load_mono(os.path.join(
        input_dir, "mardy20s_(Vocals)_mel_band_roformer_karaoke_aufr33_viperx_sdr_10.flac"), sr)
    ref_inst = _load_mono(os.path.join(
        input_dir, "mardy20s_(Instrumental)_mel_band_roformer_karaoke_aufr33_viperx_sdr_10.flac"), sr)
    ref_mix = _load_mono(os.path.join(input_dir, "mardy20s.flac"), sr)
    min_len = min(len(ref_vocal), len(ref_inst), len(ref_mix))
    return ref_vocal[:min_len], ref_inst[:min_len], ref_mix[:min_len], min_len


def classify_audio(audio_mono, ref_vocal, ref_instrumental, ref_mix, min_len):
    """Correlation classifier (thresholds per the reference)."""
    y = np.asarray(audio_mono)[:min_len]
    if len(y) < min_len:
        y = np.pad(y, (0, min_len - len(y)))
    with np.errstate(invalid="ignore"):  # silent stems: corr is nan by design
        corr_vocal = float(np.corrcoef(y, ref_vocal)[0, 1])
        corr_inst = float(np.corrcoef(y, ref_instrumental)[0, 1])
        corr_mix = float(np.corrcoef(y, ref_mix)[0, 1])
    rms = float(np.sqrt(np.mean(y ** 2)))
    if corr_mix > 0.95:
        detected = "FULL_MIX"
    elif rms < 0.005:
        detected = "SILENT"
    elif corr_vocal > corr_inst and corr_vocal > 0.5:
        detected = "VOCALS"
    elif corr_inst > corr_vocal and corr_inst > 0.5:
        detected = "INSTRUMENTAL"
    else:
        detected = "UNCLEAR"
    return corr_vocal, corr_inst, corr_mix, rms, detected


_LABEL_CONTENT = {
    "vocals": "VOCALS",
    "lead vocals": "VOCALS",
    "backing vocals": "VOCALS",
    "instrumental": "INSTRUMENTAL",
    "other": "INSTRUMENTAL",
    "no vocals": "INSTRUMENTAL",
}


def verify_stem(file_path: str, label: str, ref_vocal, ref_instrumental, ref_mix,
                min_len, sr: int = 44100) -> StemVerification:
    mono = _load_mono(file_path, sr)
    corr_vocal, corr_inst, corr_mix, rms, detected = classify_audio(
        mono, ref_vocal, ref_instrumental, ref_mix, min_len)
    expected = _LABEL_CONTENT.get(label.lower())
    matches = expected is None or detected == expected or detected == "UNCLEAR"
    return StemVerification(file_path, label, corr_vocal, corr_inst, corr_mix,
                            rms, detected, matches)


# ---------------------------------------------------------------------------
# Regression-tier label policy (the stem taxonomy of the reference's
# all-models run, ref: tests/regression/test_all_models_stem_verification.py:
# 52-92 category tables, 112-173 per-category rules). Category membership is a
# behavioural contract of the UVR model ecosystem, not implementation.

VOCAL_STEMS = {"vocals", "vocal", "lead vocals", "backing vocals",
               "lead_only", "backing_only"}
INSTRUMENTAL_STEMS = {"instrumental", "inst", "karaoke", "no_vocals", "no vocals"}
#: Single-instrument (or "everything but X") stems: legitimately near-silent
#: when the source lacks that instrument, or ≈mix for a "no X" with X absent.
SUB_STEMS = {"drums", "bass", "guitar", "piano", "other", "synthesizer",
             "strings", "woodwinds", "brass", "wind inst", "no drums",
             "no bass", "no guitar", "no piano", "no other", "no synthesizer",
             "no strings", "no woodwinds", "no brass", "no wind inst",
             "drum-bass", "no drum-bass",
             "kick", "snare", "toms", "hh", "ride", "crash",
             "male", "female", "aspiration", "bleed", "no bleed"}
#: Artifact-removal models: the "cleaned" stem ≈ the mix on clean sources and
#: the artifact stem may be near-silent — both are correct behaviour.
UTILITY_STEMS = {"echo", "no echo", "reverb", "no reverb", "noreverb",
                 "noise", "no noise", "dry", "no dry", "crowd", "no crowd"}
#: Vocal subsets that won't correlate strongly with the full-vocal reference.
PARTIAL_VOCAL_STEMS = {"lead vocals", "backing vocals", "lead_only",
                       "backing_only", "with_lead_vocals", "with_backing_vocals"}
#: Models whose primary stems deliberately deviate from the standard
#: vocal/instrumental references (backing-vocal extractors, de-echo/noise/
#: reverb) — verified in relaxed (warn-only) mode.
SPECIALIZED_MODEL_PATTERNS = ("BVE", "De-Echo", "DeEcho", "DeNoise",
                              "De-Noise", "De-Reverb", "DeReverb")


def verify_stem_label(file_path: str, label: str, ref_vocal, ref_instrumental,
                      ref_mix, min_len, sr: int = 44100) -> Tuple[bool, str]:
    """Full regression-tier verdict for one output stem: (passed, message).

    Applies the per-category policy: utility/sub stems always pass (content
    freedom is legitimate), every other stem must be non-silent and not the
    untouched mix, and primary vocal/instrumental labels must classify as
    their label with correlation ≥ 0.7.
    """
    mono = _load_mono(file_path, sr)
    cv, ci, cm, rms, detected = classify_audio(
        mono, ref_vocal, ref_instrumental, ref_mix, min_len)
    low = label.lower()

    if low in UTILITY_STEMS:
        return True, f"OK utility stem (detected={detected}, corr_m={cm:.3f}, rms={rms:.4f})"
    if low in SUB_STEMS:
        return True, f"OK sub-stem (detected={detected}, corr_m={cm:.3f}, rms={rms:.4f})"
    if rms < 0.001:
        return False, f"SILENT (rms={rms:.6f})"
    if cm > 0.95:
        return False, (f"FULL_MIX (corr_mix={cm:.3f}) — stem contains the "
                       f"original mix, not a separation")
    if low in PARTIAL_VOCAL_STEMS:
        return True, f"OK partial vocal (detected={detected}, corr_v={cv:.3f})"

    issues = []
    if low in VOCAL_STEMS or ("vocal" in low and "no" not in low):
        if detected != "VOCALS":
            issues.append(f"labeled '{label}' but detected {detected} "
                          f"(corr_v={cv:.3f}, corr_i={ci:.3f})")
        if cv < 0.7:
            issues.append(f"low vocal correlation ({cv:.3f}) for vocal-labeled stem")
    elif low in INSTRUMENTAL_STEMS:
        if detected != "INSTRUMENTAL":
            issues.append(f"labeled '{label}' but detected {detected} "
                          f"(corr_v={cv:.3f}, corr_i={ci:.3f})")
        if ci < 0.7:
            issues.append(f"low instrumental correlation ({ci:.3f}) for "
                          f"instrumental-labeled stem")
    else:
        issues.append(f"unknown stem type '{label}' — cannot verify content "
                      f"(detected={detected})")

    if issues:
        return False, "; ".join(issues)
    return True, (f"OK (detected={detected}, corr_v={cv:.3f}, "
                  f"corr_i={ci:.3f}, corr_m={cm:.3f})")


def is_specialized_model(model_filename: str, friendly_name: str = "") -> bool:
    hay = (model_filename + " " + friendly_name).lower()
    return any(p.lower() in hay for p in SPECIALIZED_MODEL_PATTERNS)
