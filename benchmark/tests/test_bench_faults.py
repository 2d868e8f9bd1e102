"""A run sees ``correct`` come out false when the timed path is broken
underneath it, once for each fault its cell can have: an answer altered
where it is produced (a separated stem, a served stem), a training step that
returns its state unchanged, and half of the batch left out with the mean
taken over the rest. The look for a chip is skipped (the CPU at a tiny
configuration); the rest of the run is the card's."""

import pytest

from cpu_runs import run_tiny


def _alter(cls):
    forward = cls.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        out = out.clone()
        out[..., ::7] *= 1.25  # a few samples in every window altered
        return out

    return altered


@pytest.mark.parametrize("cell, module, cls", [
    ("bsroformer_fp32_songs", "audio_separator_tpu_torch.models.roformer", "Roformer"),
    ("htdemucs_songs", "audio_separator_tpu_torch.models.htdemucs", "HTDemucs"),
    ("bsroformer_remote_clips", "audio_separator_tpu_torch.models.roformer", "Roformer"),
])
def test_an_altered_answer_is_not_correct(monkeypatch, cell, module, cls):
    import importlib

    klass = getattr(importlib.import_module(module), cls)
    monkeypatch.setattr(klass, "forward", _alter(klass))
    rc, result, err = run_tiny(cell, seconds=2 if "remote" in cell else 0.5)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


def _broken_steps(monkeypatch, fault):
    from audio_separator_tpu_torch import training

    make = training.make_train_step

    def make_broken(cfg, model, optimizer, **kwargs):
        if fault == "unchanged":
            optimizer.step = lambda *a, **k: None
        step = make(cfg, model, optimizer, **kwargs)
        if fault == "half_batch":
            def half(mix, target):
                n = mix.shape[0] // 2
                return step(mix[:n], target[:n])
            return half
        return step

    monkeypatch.setattr(training, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    _broken_steps(monkeypatch, fault)
    rc, result, err = run_tiny("bsroformer_bf16_finetune")
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]
