"""The band stages of a RoFormer forward (``models/roformer.py``): the
``kernel.band_split``, ``kernel.mask_estimate`` and ``kernel.band_merge``
spans, one call each a forward, counted from a span's attributes (``batch``
windows of ``frames`` STFT frames, ``bands`` bands in ``runs`` runs of equal
width, ``hidden_layers`` hidden layers in each band's mask MLP, ``features``
packed features the bands cover, a feature counted once a band that covers
it) and the model's sizes (:func:`model_sizes`).

Operations are the products' (the norms, tanh, gates and adds are a few
operations an element, which the bound leaves out as the kernels' counts
do): the band split's per-band linear, the mask estimator's hidden layers
and its value and gate products. Bytes: each input read once (the spectrum's
features once, though overlapping bands read some twice), each weight once,
each output written once; the activations between the mask estimator's
layers are left out, as a fused estimator would keep them. The merge does no
product: it reads the bands' float32 masks and writes the spectrum's."""


def model_sizes(model: dict) -> dict:
    """The sizes :func:`count` takes from a configuration's ``model``
    section."""
    dim = int(model["dim"])
    channels = 2 if model.get("stereo") else 1
    return {"dim": dim, "hidden": dim * int(model.get("mlp_expansion_factor", 4)),
            "stems": int(model.get("num_stems", 1)),
            "n_feat": (int(model["stft_n_fft"]) // 2 + 1) * channels * 2}


def count(stage: str, batch: int, frames: int, bands: int, runs: int, hidden_layers: int,
          features: int, dim: int, hidden: int, stems: int, n_feat: int,
          itemsize: int) -> tuple:
    rows = batch * frames
    if stage == "band_split":
        ops = 2 * rows * features * dim
        weights = features * dim + features + bands * dim
        nbytes = (rows * n_feat + weights + rows * bands * dim) * itemsize
        return ops, nbytes
    if stage == "mask_estimate":
        deep = max(hidden_layers - 1, 0)
        final_in = hidden if hidden_layers else dim
        hidden_ops = 2 * dim * hidden + deep * 2 * hidden * hidden if hidden_layers else 0
        ops = stems * rows * (bands * hidden_ops + 2 * final_in * 2 * features)
        hidden_weights = (dim * hidden + hidden + deep * (hidden * hidden + hidden)
                          if hidden_layers else 0)
        weights = stems * (bands * hidden_weights + final_in * 2 * features + 2 * features)
        nbytes = (rows * bands * dim + weights) * itemsize + stems * rows * features * 4
        return ops, nbytes
    if stage == "band_merge":
        return 0, stems * rows * (features + n_feat) * 4
    raise ValueError(f"no band stage {stage!r}")
