"""The device mesh: data parallelism over window batches and training
batches, Megatron tensor parallelism inside the RoFormer blocks and the
HTDemucs cross-transformer feed-forwards.

Port of ``audio_separator_tpu/parallel/mesh.py``. In the JAX package one
process drives all its local devices, a ``Mesh`` is a ``(dp, tp)`` grid of
them and XLA partitions the program over both axes, placing either axis
anywhere, across processes too. The port keeps the one-process model:

* :class:`Mesh` is a ``(dp, tp)`` grid of ``torch.device`` handles under the
  axis names ``("data", "model")``. Handles may repeat, the port's
  counterpart of XLA's virtual host devices: ``[torch.device("cpu")] * 4``
  is a 2 × 2 mesh on the CPU, ``[cuda:0] * 4`` one on a single card.
* Data axis: independent work (a track's windows, a training batch) is
  split into one slice a row, each run on the row's first device; the
  results are copied to the mesh's first device (``ops/demix.py``,
  ``training.py``).
* Model axis: the Megatron placements below. A sharded module
  (:func:`shard_roformer_params`, :func:`shard_htdemucs_params`) keeps each
  column- or row-parallel weight as ``tp`` shards, shard ``s`` on device
  ``s`` of the row. Column-parallel outputs stay on their shard's device;
  row-parallel partial products are copied to the row's first device and
  added there: that add is the all-reduce. Autograd carries gradients back
  across those copies, so no collective is written by hand inside a process.
* Across processes only the data axis spans: :func:`init_distributed_from_env`
  joins a ``torch.distributed`` group, and the mesh's ``data`` extent becomes
  the sum of every process's rows. Tensor parallelism stays inside a process.
  ``torch.distributed`` carries the training gradients' all-reduce over the
  data axis (``gloo`` on the CPU, ``nccl`` on the card) and the dry run's
  reduction (``parallel/dcn_dryrun.py``).

The engine and ``Separator(use_mesh=...)`` use the data axis only (a
replicated model on each row's first device), as the JAX ``Separator`` does.
"""

from __future__ import annotations

import copy
import datetime
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.tracing import span

__all__ = ["Mesh", "init_distributed_from_env", "make_mesh", "canonical_device",
           "roformer_param_shardings", "htdemucs_param_shardings", "shard_roformer_params",
           "shard_htdemucs_params", "shard_model", "gather_params", "is_sharded",
           "wqkv_shard_columns", "call_on_row"]

AXES = ("data", "model")
_initialized = False


def init_distributed_from_env(timeout_s: int = 120, backend: Optional[str] = None) -> bool:
    """Join a ``torch.distributed`` process group when the environment says
    so; the data axis of every later :func:`make_mesh` then spans the
    processes. The contract (all three, or nothing happens):

    * ``AUDSEP_COORDINATOR``   — ``host:port`` of process 0
    * ``AUDSEP_NUM_PROCESSES`` — total process count
    * ``AUDSEP_PROCESS_ID``    — this process's rank (0-based)

    ``backend``: ``nccl`` for CUDA meshes, ``gloo`` for CPU ones; by default
    ``nccl`` where a CUDA device is present. Idempotent; returns True when the
    process is in a group, False without the contract."""
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get("AUDSEP_COORDINATOR")
    nproc = os.environ.get("AUDSEP_NUM_PROCESSES")
    pid = os.environ.get("AUDSEP_PROCESS_ID")
    if not (coord and nproc and pid):
        return False
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if torch.cuda.is_available() else "gloo"),
            init_method=f"tcp://{coord}", world_size=int(nproc), rank=int(pid),
            timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True
    return True


def _process_group():
    """``(count, index)`` of the processes the data axis spans."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def canonical_device(device) -> torch.device:
    """``device`` with its index made explicit (``cuda`` is the current
    card), so that two handles of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``(dp, tp)`` grid of this process's devices, axes ``("data",
    "model")``. ``devices[r][s]`` is shard ``s`` of row ``r``; handles may
    repeat. ``shape`` is the global extent, as in JAX: over a process group
    the data axis counts every process's rows (``local_rows`` are this
    process's)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, process_count: int = 1, process_index: int = 0):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = canonical_device(devices[idx])
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, tp) grid, got shape {grid.shape}")
        self.devices = grid
        self.process_count = process_count
        self.process_index = process_index

    @property
    def local_rows(self) -> int:
        return self.devices.shape[0]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.local_rows * self.process_count, "model": self.devices.shape[1]}

    @property
    def first(self) -> torch.device:
        """The device where a row's results meet: row 0, shard 0."""
        return self.devices[0, 0]

    def row(self, r: int) -> list:
        return list(self.devices[r])

    def row_devices(self) -> list:
        """Each local row's first device, where its data slice runs."""
        return [self.devices[r, 0] for r in range(self.local_rows)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``("data", "model")`` mesh, with the defaults and errors of the
    JAX ``make_mesh``: pure data parallelism unless ``tp`` is given.

    ``devices``: this process's device handles (they may repeat, e.g. four
    CPU handles); by default every local CUDA device, joining the process
    group of :func:`init_distributed_from_env` first (it raises without a
    card). ``n_devices`` keeps the first ``n`` of them. In a process group the
    grid's device count, and so ``dp``, counts every process's devices (each
    process brings as many); ``tp`` stays inside a process."""
    if devices is None:
        init_distributed_from_env()
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] "
                               "(e.g. [torch.device('cpu')] * 4) for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    count, index = _process_group()
    n = len(devices) * count
    if tp is None and dp is None:
        dp, tp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    if dp % count:
        raise ValueError(f"the data axis ({dp}) must split evenly over {count} processes "
                         f"(tensor parallelism stays inside a process)")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp // count, tp), count, index)


# ---------------------------------------------------------------------------
# Placements: "col" (split on the output features, the last axis), "row"
# (split on the input features, axis -2) or "rep" (replicated), one a leaf,
# under the JAX parameter tree's names.


def _roformer_placement(path: tuple) -> str:
    key = path[-1] if path else ""
    in_mask_est = "mask_est" in path
    if key in ("wqkv", "ff_w1") or (in_mask_est and key == "w"):
        return "col"
    if key in ("wo", "ff_w2") or (in_mask_est and key in ("val_w", "gate_w")):
        return "row"
    return "rep"


def _htdemucs_placement(path: tuple) -> str:
    if "crosstransformer" in path and len(path) >= 2:
        parent, key = path[-2], path[-1]
        if parent == "linear1" and key in ("weight", "bias"):
            return "col"  # (hidden, E) on axis 0 and (hidden,): the output features
        if parent == "linear2" and key == "weight":
            return "row"  # (E, hidden) on axis 1; the bias is added once
    return "rep"


def _walk(tree, rule, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, rule, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, rule, path) for v in tree)
    return rule(path)


def roformer_param_shardings(params: Dict[str, Any]) -> Dict[str, Any]:
    """The placement of every leaf of a RoFormer parameter tree (the JAX
    layout, e.g. ``models/convert.export_jax_params``), the leaf sets of the
    JAX ``roformer_param_shardings``: column-parallel ``wqkv`` and ``ff_w1``
    and the mask estimator's hidden ``w``; row-parallel ``wo``, ``ff_w2`` and
    the mask estimator's ``val_w`` and ``gate_w``; the rest replicated (the
    gate weights and biases of the column-parallel products are sliced per
    shard where they are used). In every stack, the linear-attention one too.

    One difference in how a column split is cut: ``wqkv``'s columns are laid
    out ``(3, heads, dh)``, and the JAX package cuts them into contiguous
    blocks (at tp 2 the first shard holds all of q and half of k, so XLA
    reshards before attention). The port gives each shard the q, k and v
    columns of the same heads (:func:`wqkv_shard_columns`)."""
    return _walk(params, _roformer_placement)


def htdemucs_param_shardings(params: Dict[str, Any]) -> Dict[str, Any]:
    """The placement of every leaf of an HTDemucs / HDemucs parameter tree,
    the JAX ``htdemucs_param_shardings``: the cross-transformer feed-forwards
    column-parallel in ``linear1`` (weight and bias) and row-parallel in
    ``linear2.weight``; attention (its packed ``in_proj_weight`` would split
    across the q, k, v boundary) and the convolutions replicated."""
    return _walk(params, _htdemucs_placement)


def wqkv_shard_columns(heads: int, dim_head: int, tp: int, s: int) -> np.ndarray:
    """The columns of ``wqkv (…, 3·heads·dh)`` that shard ``s`` of ``tp``
    holds: q, k and v of heads ``[s·heads/tp, (s+1)·heads/tp)``, in that
    order, which is the packed layout of a block of ``heads/tp`` heads."""
    hs = heads // tp
    cols = np.arange(3 * heads * dim_head).reshape(3, heads, dim_head)
    return cols[:, s * hs : (s + 1) * hs].reshape(-1)


# ---------------------------------------------------------------------------
# Sharded modules.


def _put(root: nn.ModuleDict, name: str, param: nn.Parameter) -> None:
    """Place ``param`` in a tree of ModuleDicts under the dotted ``name``."""
    *path, leaf = name.split(".")
    node = root
    for i, part in enumerate(path):
        if part not in node:
            node[part] = nn.ParameterDict() if i == len(path) - 1 else nn.ModuleDict()
        node = node[part]
    node[leaf] = param


def _owner(module: nn.Module, name: str):
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    return module, leaf


def _copy_to(model: nn.Module, device) -> nn.Module:
    """A copy of ``model`` on ``device``, without the RoFormer's prepared
    3xTF32 forms (made again for the copy at first use)."""
    cache = model.__dict__.get("_tf32_cache")
    copied = copy.deepcopy(model, memo={} if cache is None else {id(cache): None})
    copied.__dict__.pop("_tf32_cache", None)
    return copied.to(device)


def is_sharded(module: nn.Module) -> bool:
    return getattr(module, "mesh", None) is not None


def _check_tp(mesh: Mesh, what: str, **widths: int) -> int:
    tp = mesh.shape["model"]
    for name, width in widths.items():
        if width % tp:
            raise ValueError(f"{what}: {name}={width} does not split over tp={tp}")
    return tp


def shard_roformer_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """A tensor-parallel copy of a ``Roformer``: the replicated leaves on the
    mesh's first device, each column- or row-parallel leaf as ``tp`` shards
    in ``tp_shards``, shard ``s`` on ``mesh.devices[0][s]``. Its forward
    launches each block's partial form once a shard (``models/roformer.py``).
    Needs ``heads``, the FF hidden width and ``dim`` (the row split of the
    mask estimator's final products without a hidden layer) divisible by
    ``tp``. ``model`` is left as it was."""
    if is_sharded(model):
        raise ValueError("shard_roformer_params: the module is sharded already")
    cfg = model.cfg
    hidden = cfg.dim * cfg.mlp_expansion_factor
    tp = _check_tp(mesh, "shard_roformer_params", heads=cfg.heads, hidden=hidden, dim=cfg.dim)
    devices = mesh.row(0)
    sharded = _copy_to(model, mesh.first)
    shards = [nn.ModuleDict() for _ in range(tp)]
    for name, p in list(sharded.named_parameters()):
        placement = _roformer_placement(tuple(name.split(".")))
        if placement == "rep":
            continue
        owner, leaf = _owner(sharded, name)
        del owner[leaf]
        for s, shard in enumerate(shards):
            if name.endswith("wqkv"):
                dh = cfg.dim_head
                piece = p.data[..., torch.as_tensor(wqkv_shard_columns(cfg.heads, dh, tp, s))]
            else:
                piece = p.data.chunk(tp, dim=-1 if placement == "col" else -2)[s]
            _put(shard, name, nn.Parameter(piece.contiguous().to(devices[s]),
                                           requires_grad=p.requires_grad))
    sharded.tp_shards = nn.ModuleList(shards)
    sharded.mesh = mesh
    return sharded


def shard_htdemucs_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """A tensor-parallel copy of an ``HTDemucs``: each cross-transformer
    layer's feed-forward as ``tp`` ``FeedForwardShard``s (``linear1``'s
    hidden units and ``linear2``'s matching columns), shard ``s`` on
    ``mesh.devices[0][s]``; everything else replicated on the mesh's first
    device. ``model`` is left as it was."""
    from ..models.htdemucs import FeedForwardShard, RowParallelBias, _TransformerLayer

    if is_sharded(model):
        raise ValueError("shard_htdemucs_params: the module is sharded already")
    devices = mesh.row(0)
    sharded = _copy_to(model, mesh.first)
    for name, layer in sharded.named_modules():
        if not (isinstance(layer, _TransformerLayer) and "crosstransformer" in name):
            continue
        l1, l2 = layer.linear1, layer.linear2
        tp = _check_tp(mesh, "shard_htdemucs_params", hidden=l1.out_features)
        width = l1.out_features // tp
        shards = []
        for s in range(tp):
            cols = slice(s * width, (s + 1) * width)
            lin1 = nn.Linear(l1.in_features, width, device=devices[s])
            lin2 = nn.Linear(width, l2.out_features, bias=False, device=devices[s])
            with torch.no_grad():
                lin1.weight.copy_(l1.weight[cols])
                lin1.bias.copy_(l1.bias[cols])
                lin2.weight.copy_(l2.weight[:, cols])
            for p, src in ((lin1.weight, l1.weight), (lin1.bias, l1.bias),
                           (lin2.weight, l2.weight)):
                p.requires_grad_(src.requires_grad)
            shards.append(FeedForwardShard(lin1, lin2))
        del layer.linear1
        layer.linear2 = RowParallelBias(l2.bias.data)
        layer.linear2.bias.requires_grad_(l2.bias.requires_grad)
        layer.tp_shards = nn.ModuleList(shards)
    sharded.mesh = mesh
    return sharded


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """The module laid out for ``mesh``: tensor-parallel when the model axis
    is wider than one (a ``Roformer`` or an ``HTDemucs``/``HDemucs``), else a
    copy on the mesh's first device. Build the optimizer over the result's
    parameters (``training.make_train_step``)."""
    from ..models.htdemucs import HTDemucs
    from ..models.roformer import Roformer

    if mesh.shape["model"] == 1:
        sharded = _copy_to(model, mesh.first)
        sharded.mesh = mesh
        return sharded
    if isinstance(model, Roformer):
        return shard_roformer_params(model, mesh)
    if isinstance(model, HTDemucs):
        return shard_htdemucs_params(model, mesh)
    raise TypeError(f"no tensor-parallel layout for {type(model).__name__}")


def _shard_index(name: str) -> Optional[int]:
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part == "tp_shards":
            return int(parts[i + 1])
    return None


def gather_params(model: nn.Module) -> nn.Module:
    """An unsharded copy of a module built by :func:`shard_model` (or
    ``model`` itself if it is not sharded), on the mesh's first device: the
    shards joined back into the full weights, e.g. to export them
    (``models/convert.export_jax_params``)."""
    if not is_sharded(model):
        return model
    from ..models.htdemucs import HTDemucs
    from ..models.roformer import Roformer

    state = model.state_dict()
    if not any(_shard_index(k) is not None for k in state):  # laid out for tp 1
        full = _copy_to(model, model.mesh.first)
        full.mesh = None
        return full
    if isinstance(model, Roformer):
        full = Roformer(model.cfg).to(device=model.mesh.first, dtype=model.band_split.b.dtype)
        tp = len(model.tp_shards)
        merged = {k: v for k, v in state.items() if _shard_index(k) is None}
        for name in full.state_dict():
            if name in merged:
                continue
            pieces = [state[f"tp_shards.{s}.{name}"].to(model.mesh.first) for s in range(tp)]
            if name.endswith("wqkv"):
                cfg = model.cfg
                cols = np.concatenate([wqkv_shard_columns(cfg.heads, cfg.dim_head, tp, s)
                                       for s in range(tp)])
                joined = torch.cat(pieces, dim=-1)
                merged[name] = joined[..., torch.as_tensor(np.argsort(cols))]
            else:
                col = _roformer_placement(tuple(name.split("."))) == "col"
                merged[name] = torch.cat(pieces, dim=-1 if col else -2)
        full.load_state_dict(merged)
    elif isinstance(model, HTDemucs):
        full = type(model)(model.cfg).to(model.mesh.first)
        dev = model.mesh.first
        merged = {k: v for k, v in state.items() if _shard_index(k) is None}
        for prefix in {k.split(".tp_shards.")[0] for k in state if ".tp_shards." in k}:
            tp = len(getattr(model.get_submodule(prefix), "tp_shards"))
            shard = [f"{prefix}.tp_shards.{s}." for s in range(tp)]
            for leaf, axis in (("linear1.weight", 0), ("linear1.bias", 0),
                               ("linear2.weight", 1)):
                merged[f"{prefix}.{leaf}"] = torch.cat([state[p + leaf].to(dev)
                                                        for p in shard], dim=axis)
        full.load_state_dict(merged)
    else:
        raise TypeError(f"no tensor-parallel layout for {type(model).__name__}")
    return full


def _row_devices_for(model: nn.Module, mesh: Mesh, r: int) -> Dict[str, torch.device]:
    """Where each parameter and buffer of ``model`` lies on row ``r``: shard
    ``s``'s on ``mesh.devices[r][s]``, the replicated ones on the row's first."""
    names = [n for n, _ in model.named_parameters()] + [n for n, _ in model.named_buffers()]
    return {n: mesh.devices[r, _shard_index(n) or 0] for n in names}


def call_on_row(model: nn.Module, mesh: Mesh, r: int, *args, dtype: Optional[torch.dtype] = None):
    """``model(*args)`` with the parameters laid out on row ``r`` of the mesh:
    the module itself where the row's devices are row 0's (repeated
    handles), else copies made for the call (``.to``, differentiable, so
    autograd sums their gradients onto ``model``'s own parameters).
    ``dtype``: the parameters cast to it for the call (the bf16 training
    step), on the row's devices, differentiably as well."""
    if dtype is None and all(a == b for a, b in zip(mesh.row(r), mesh.row(0))):
        return model(*args)
    where = _row_devices_for(model, mesh, r)
    with span("train.cast", row=r):
        moved = {n: p.to(where[n], dtype) for n, p in model.named_parameters()}
        moved.update((n, b.to(where[n])) for n, b in model.named_buffers())
    return torch.func.functional_call(model, moved, args)
