"""Carry the JAX package's parameters over to the port.

``jax.device_get(params)`` gives the reference's parameter tree as nested
dicts and lists of numpy arrays. :func:`from_jax_params` turns it into the
port's ordered dict: the same values in the same layout (linears
``(d_in, d_out)``, block parameters stacked over layers), keyed by the
tree path and ordered as ``jax.tree.flatten`` orders the leaves.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.transformer import Params, tree_paths


def from_jax_params(tree: Any, device=None, dtype: torch.dtype | None = None) -> Params:
    """Nested dicts/lists of numpy arrays → ordered ``path → tensor`` dict.

    An identity on values; ``dtype`` casts every leaf when given.
    """
    out: Params = {}
    for path, leaf in tree_paths(tree):
        t = torch.from_numpy(np.array(leaf, copy=True))
        out[path] = t.to(device=device, dtype=dtype or t.dtype)
    return out
