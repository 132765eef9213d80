"""Host arrays to tensors and back, for the frameworks that hand the
engine numpy arrays (``mxnet/``, ``tensorflow/``, ``keras/``).

``torch.from_numpy`` refuses bfloat16 arrays (ml_dtypes' ``bfloat16``,
which TensorFlow's ``.numpy()`` gives), so such an array goes through its
16 bits and comes back in the caller's own dtype object: no module here
imports ml_dtypes.
"""

from __future__ import annotations

import numpy as np
import torch


def host_to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s values (shared where numpy allows)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def tensor_to_host(t: torch.Tensor, shape, dtype) -> np.ndarray:
    """``t`` as a numpy array of ``shape`` and ``dtype`` (a bfloat16
    tensor into the caller's bfloat16 dtype)."""
    t = t.detach().cpu()
    dtype = np.dtype(dtype)
    if t.dtype == torch.bfloat16:
        out = t.view(torch.int16).numpy().view(dtype)
    else:
        out = t.numpy()
        if out.dtype != dtype:
            out = out.astype(dtype)
    return out.reshape(shape)
