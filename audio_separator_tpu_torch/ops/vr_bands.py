"""VR mask post-processing on the host (numpy).

Port of ``merge_artifacts`` from the JAX package's ``ops/vr_bands.py``
(ref: uvr_lib_v5/spec_utils.merge_artifacts:180-225). The region search
depends on the data, so it runs on the host: the one round trip of the VR
chain, taken only when ``enable_post_process`` is set. The rest of that
module, the numpy multiband chain behind the JAX package's
``AUDSEP_VR_CHAIN=host`` switch, is not carried: the port has one chain,
``ops/vr_chain.py``, on the device.
"""

from __future__ import annotations

import numpy as np


def merge_artifacts(y_mask: np.ndarray, thres: float = 0.01, min_range: int = 64,
                    fade_size: int = 32) -> np.ndarray:
    """Raise the mask to 1 over runs of more than ``min_range`` frames whose
    minimum exceeds ``thres``, with linear fades of ``fade_size`` frames."""
    if min_range < fade_size * 2:
        raise ValueError("min_range must be >= fade_size * 2")
    try:
        idx = np.where(y_mask.min(axis=(0, 1)) > thres)[0]
        if len(idx) == 0:
            return y_mask
        start_idx = np.insert(idx[np.where(np.diff(idx) != 1)[0] + 1], 0, idx[0])
        end_idx = np.append(idx[np.where(np.diff(idx) != 1)[0]], idx[-1])
        artifact_idx = np.where(end_idx - start_idx > min_range)[0]
        weight = np.zeros_like(y_mask)
        if len(artifact_idx) > 0:
            start_idx, end_idx = start_idx[artifact_idx], end_idx[artifact_idx]
            old_e = None
            for s, e in zip(start_idx, end_idx):
                if old_e is not None and s - old_e < fade_size:
                    s = old_e - fade_size * 2
                if s != 0:
                    weight[:, :, s : s + fade_size] = np.linspace(0, 1, fade_size)
                else:
                    s -= fade_size
                if e != y_mask.shape[2]:
                    weight[:, :, e - fade_size : e] = np.linspace(1, 0, fade_size)
                else:
                    e += fade_size
                weight[:, :, s + fade_size : e - fade_size] = 1
                old_e = e
        return y_mask + weight * (1 - y_mask)
    except Exception as exc:  # parity: the reference swallows post-process errors
        print("Post Process Failed: ", exc)
        return y_mask
