"""Sharded training over a device mesh (``training.make_train_step(mesh=)``,
``parallel/mesh.py``) and the multi-process wiring, on the CPU.

* Three SGD steps on a dp 2 × tp 2 mesh of CPU handles against the same
  steps replicated and against the JAX sharded step on its CPU mesh (its
  ``make_train_step(mesh=)``), for BS-RoFormer (tests/test_training.py's
  ``CFG``) and a small HTDemucs: losses at rtol 2e-4 and every updated leaf
  at atol 2e-4, the tolerances of tests/test_training.py. The shards keep
  their devices and shapes across the steps, and the export (the shards
  gathered) equals the replicated export.
* ``tools/finetune_torch.py --mesh --tp 2`` runs and saves.
* Two processes × 4 CPU handles under ``gloo``
  (``python -m audio_separator_tpu_torch.parallel.dcn_dryrun``,
  ``AUDSEP_DRYRUN_TP=2``): every rank sees the ``{"data": 4, "model": 2}``
  mesh, 8 global and 4 local handles, the right global sum, and the same
  weight checksum after a sharded SGD step, equal to the step of one process
  on a dp 4 × tp 2 mesh.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from audio_separator_tpu.models import htdemucs as jax_ht
from audio_separator_tpu.models.init_params import init_roformer_params
from audio_separator_tpu.parallel import mesh as jax_mesh
from audio_separator_tpu.training import make_train_step as jax_make_train_step
from audio_separator_tpu_torch.models import htdemucs as ht
from audio_separator_tpu_torch.models.convert import (export_jax_params, flatten_tree,
                                                      load_jax_htdemucs_params, load_jax_params)
from audio_separator_tpu_torch.models.init_params import init_htdemucs_params
from audio_separator_tpu_torch.models.roformer import Roformer, RoformerConfig
from audio_separator_tpu_torch.parallel import dcn_dryrun, mesh
from audio_separator_tpu_torch.training import make_train_step
from test_training import CFG as JAX_BS_CFG
from test_training import LOSS_KW, _data
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FAST_COMPILE = {"xla_backend_optimization_level": 0}
STEP_TOL = 2e-4  # tests/test_training.py:62-68
HT_KW = dict(sources=("drums", "bass", "other", "vocals"), channels=8, nfft=512, depth=2,
             t_layers=1, t_heads=2, segment=0.25)


def _roformer_case():
    tree = init_roformer_params(JAX_BS_CFG, seed=0)
    cfg = RoformerConfig(**{k: getattr(JAX_BS_CFG, k)
                            for k in RoformerConfig.__dataclass_fields__})
    mix, target = (np.asarray(a) for a in _data(4, seed=1))
    return JAX_BS_CFG, tree, lambda: load_jax_params(Roformer(cfg), tree), mix, target, LOSS_KW


def _htdemucs_case():
    cfg = ht.HTDemucsConfig(**HT_KW)
    tree = init_htdemucs_params(cfg, seed=9)
    known = jax_ht.HTDemucsConfig.__dataclass_fields__
    jcfg = jax_ht.HTDemucsConfig(**{k: v for k, v in HT_KW.items() if k in known})
    rng = np.random.default_rng(4)
    mix = rng.standard_normal((4, 2, cfg.training_length)).astype(np.float32) * 0.2
    target = (0.5 * rng.standard_normal((4, 4, 2, cfg.training_length)).astype(np.float32) * 0.2
              + 0.5 * mix[:, None])
    return jcfg, tree, lambda: load_jax_htdemucs_params(ht.HTDemucs(cfg), tree), mix, target, {}


def _port_steps(model, mix, target, loss_kw, m=None, steps=3):
    step = make_train_step(model.cfg, model, torch.optim.SGD(model.parameters(), lr=1e-2),
                           mesh=m, **loss_kw)
    tmix, ttarget = torch.from_numpy(mix.copy()), torch.from_numpy(target.copy())
    return [float(step(tmix, ttarget)) for _ in range(steps)]


@pytest.mark.parametrize("case", ["bs_roformer", "htdemucs"])
def test_sharded_sgd_steps_match_replicated_and_jax(case):
    jcfg, tree, build, mix, target, loss_kw = {"bs_roformer": _roformer_case,
                                               "htdemucs": _htdemucs_case}[case]()
    m = mesh.make_mesh(devices=[CPU] * 4, dp=2, tp=2)
    replicated = build()
    sharded = mesh.shard_model(build(), m)
    layout = {n: (tuple(p.shape), p.device) for n, p in sharded.named_parameters()
              if "tp_shards" in n}
    assert layout, "no parameter was sharded"
    want_losses = _port_steps(replicated, mix, target, loss_kw)
    got_losses = _port_steps(sharded, mix, target, loss_kw, m=m)
    np.testing.assert_allclose(got_losses, want_losses, rtol=STEP_TOL)
    assert {n: (tuple(p.shape), p.device) for n, p in sharded.named_parameters()
            if "tp_shards" in n} == layout
    got, want = flatten_tree(export_jax_params(sharded)), flatten_tree(
        export_jax_params(replicated))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=STEP_TOL, err_msg=key)

    jm = jax_mesh.make_mesh(n_devices=4, dp=2, tp=2)
    jstep, jstate = jax_make_train_step(jcfg, optax.sgd(1e-2), tree, mesh=jm, **loss_kw)
    shardings = (jax_mesh.roformer_param_shardings if case == "bs_roformer"
                 else jax_mesh.htdemucs_param_shardings)(tree, jm)
    params = jax.tree.map(jax.device_put, tree, shardings)  # the layout the step keeps
    data = NamedSharding(jm, P("data"))
    jmix, jtarget = jax.device_put(mix, data), jax.device_put(target, data)
    jstep = jstep.lower(params, jstate, jmix, jtarget).compile(compiler_options=FAST_COMPILE)
    jlosses = []
    for _ in range(3):
        params, jstate, loss = jstep(params, jstate, jmix, jtarget)
        jlosses.append(float(loss))
    np.testing.assert_allclose(got_losses, jlosses, rtol=STEP_TOL)
    jtree = flatten_tree(jax.tree.map(np.asarray, params))
    assert sorted(jtree) == sorted(got)
    for key in jtree:
        np.testing.assert_allclose(got[key], jtree[key], atol=STEP_TOL, err_msg=key)


def test_sharded_step_refuses_a_module_not_laid_out_for_its_mesh():
    tree = init_roformer_params(JAX_BS_CFG, seed=0)
    model = load_jax_params(Roformer(RoformerConfig(
        **{k: getattr(JAX_BS_CFG, k) for k in RoformerConfig.__dataclass_fields__})), tree)
    m = mesh.make_mesh(devices=[CPU] * 4, tp=2)
    with pytest.raises(ValueError, match="shard_model"):
        make_train_step(model.cfg, model, torch.optim.SGD(model.parameters(), lr=1e-2), mesh=m)
    sharded = mesh.shard_model(model, m)
    step = make_train_step(model.cfg, sharded, torch.optim.SGD(sharded.parameters(), lr=1e-2),
                           mesh=m, **LOSS_KW)
    mix, target = (torch.from_numpy(np.asarray(a)) for a in _data(3))
    with pytest.raises(ValueError, match="does not split"):
        step(mix, target)


def test_finetune_tool_trains_over_a_cpu_mesh(tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import finetune_torch
    finally:
        sys.path.pop(0)
    out = str(tmp_path / "tuned.npz")
    finetune_torch.main(["--device", "cpu", "--steps", "2", "--mesh", "--tp", "2",
                         "--dim", "32", "--depth", "1", "--save", out])
    printed = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in printed and "step   1" in printed
    assert os.path.exists(out)


# ------------------------------------------------------------------ processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_group(port):
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                    "OMP_NUM_THREADS": "1",
                    "AUDSEP_COORDINATOR": f"127.0.0.1:{port}",
                    "AUDSEP_NUM_PROCESSES": "2", "AUDSEP_PROCESS_ID": str(pid),
                    "AUDSEP_DRYRUN_TP": "2", "AUDSEP_DRYRUN_CPU_HANDLES": "4"})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "audio_separator_tpu_torch.parallel.dcn_dryrun"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def test_two_processes_share_one_mesh_and_one_sharded_step():
    # One retry on a fresh port, as tests/test_multihost.py does: the
    # localhost rendezvous stalls now and then under load.
    results = []
    for attempt in range(2):
        procs = _launch_group(_free_port())
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            if attempt == 0:
                continue
            raise
        results = []
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\nstdout={out}\nstderr={err}"
            results.append(json.loads([line for line in out.splitlines()
                                       if line.startswith("{")][-1]))
        break
    single = dcn_dryrun.sgd_checksum(mesh.make_mesh(devices=[CPU] * 8, tp=2))
    for r in results:
        assert r["ok"] is True and r["joined_cluster"] is True
        assert r["num_processes"] == 2
        assert r["devices_global"] == 8 and r["devices_local"] == 4
        assert r["mesh"] == {"data": 4, "model": 2}
        assert r["sum"] == r["want"]
        np.testing.assert_allclose(r["checksum"], single, rtol=1e-6)
    assert {r["process"] for r in results} == {0, 1}
    assert results[0]["checksum"] == results[1]["checksum"]
