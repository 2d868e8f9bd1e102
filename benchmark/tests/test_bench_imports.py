"""The check against JAX and the JAX package compares whole top-level
names: the port's name begins with the JAX package's."""

import pytest

import run


@pytest.mark.parametrize("names, found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["audio_separator_tpu", "audio_separator_tpu.models"], ["audio_separator_tpu"]),
    (["audio_separator_tpu_torch", "audio_separator_tpu_torch.models.roformer"], []),
    (["jaxtyping", "jax_tools", "audio_separator_tpu_tools"], []),
])
def test_forbidden_modules(names, found):
    assert run.forbidden_modules(names) == found


def test_a_run_prints_nothing_when_jax_is_loaded(monkeypatch, capsys):
    import sys
    import types

    from cpu_runs import run_tiny

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, result, err = run_tiny("bsroformer_fp32_songs")
    assert rc != 0 and result is None and "jax" in err
