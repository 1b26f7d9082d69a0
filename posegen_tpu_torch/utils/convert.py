"""The weight bridge: a posegen_tpu parameter tree, as nested dicts and lists
of numpy arrays, -> the port's parameters.

Both packages keep the same tree layout ({"coarse": {"pts_linears":
[{"w", "b"}, ...], "alpha_linear", ...}, "fine": ..., "embed_kp": {"tau",
"alpha", "cutoff_dist"}, ...}) and linear weights stored (in, out), so the
bridge converts leaves only; the two then compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dicts / lists / tuples of array-likes -> the same structure of
    tensors on `device` (floats as float32, integers as int64)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.as_tensor(a).to(device)
