"""Host batch -> device tensors.

Port of ``SegmentBatch.to_device`` (``brainmagick_tpu/dataset.py``).
``to_device`` takes any object with the ``ARRAY_FIELDS`` attributes (the
JAX package's ``SegmentBatch``, or a plain namespace of numpy arrays).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

#: a copy of brainmagick_tpu.dataset.SegmentBatch.ARRAY_FIELDS (that
#: module imports jax through its feature extractors)
ARRAY_FIELDS = ("meg", "features", "features_mask", "subject_index",
                "recording_index", "positions")
_INDEX_FIELDS = ("subject_index", "recording_index")


def _as_tensor(value: tp.Any) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(value))
    if arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (the bf16 wire format): same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_device(batch: tp.Any, device: tp.Union[str, torch.device]
              ) -> tp.Dict[str, torch.Tensor]:
    """Copy the batch's arrays to `device`: indices as int64, the rest in
    their own dtype. For a CUDA device the host copy is pinned and the
    transfer is non-blocking on the current stream."""
    device = torch.device(device)
    out = {}
    for name in ARRAY_FIELDS:
        tensor = _as_tensor(getattr(batch, name))
        if name in _INDEX_FIELDS:
            tensor = tensor.long()
        if device.type == "cuda":
            tensor = tensor.pin_memory().to(device, non_blocking=True)
        else:
            tensor = tensor.to(device)
        out[name] = tensor
    return out
