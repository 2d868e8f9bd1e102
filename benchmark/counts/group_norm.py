"""The GroupNorm kernel of the Demucs models (``ops/group_norm.py``,
``csrc/group_norm.cu``): one ``kernel.group_norm`` span a launch, counted
from its attributes (``rows`` statistics rows of ``row_len`` elements,
``channels``, the ``epilogue``, whether a ``scale`` and a ``residual`` were
given).

No products: operations 0. Bytes: every input element read once, every
output element written once (half as many as the inputs under the GLU
epilogue), the residual read once where there is one, γ and β once (and the
GLU's scale). The kernel's second read of its input (statistics, then the
apply pass) is left out: the bound counts what the function needs."""


def count(rows: int, row_len: int, channels: int, epilogue: str, itemsize: int,
          scale: bool = False, residual: bool = False, **_sizes) -> tuple:
    n_in = rows * row_len
    n_out = n_in // 2 if epilogue == "glu_scale_residual" else n_in
    params = 2 * channels + (channels // 2 if scale else 0)
    return 0, (n_in + n_out + (n_out if residual else 0) + params) * itemsize
