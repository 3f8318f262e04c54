"""Host batch -> device tensors.

Port of ``SegmentBatch.to_device`` (``brainmagick_tpu/dataset.py``).
``to_device`` takes any object with the ``ARRAY_FIELDS`` attributes (the
JAX package's ``SegmentBatch``, or a plain namespace of numpy arrays).
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .precision import torch_dtype

#: a copy of brainmagick_tpu.dataset.SegmentBatch.ARRAY_FIELDS (that
#: module imports jax through its feature extractors)
ARRAY_FIELDS = ("meg", "features", "features_mask", "subject_index",
                "recording_index", "positions")
_INDEX_FIELDS = ("subject_index", "recording_index")
#: the float payloads ``transfer_dtype`` casts
_WIRE_FIELDS = ("meg", "features")


def _as_tensor(value: tp.Any) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(value))
    if arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (the bf16 wire format): same bits as torch's
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_device(batch: tp.Any, device: tp.Union[str, torch.device],
              transfer_dtype: tp.Optional[str] = None
              ) -> tp.Dict[str, torch.Tensor]:
    """Copy the batch's arrays to `device`: indices as int64, the rest in
    their own dtype, except that with `transfer_dtype` (``'bfloat16'``,
    ``parallel.transfer_dtype``) meg and features, when floating, are cast
    to it on the host, halving the bytes of the transfer; an array already
    in that type is not copied for the cast. For a CUDA device each array
    is copied once on the host, into page-locked memory, casting as it
    goes, and the transfer is non-blocking on the current stream."""
    device = torch.device(device)
    wire = torch_dtype(transfer_dtype)
    out = {}
    for name in ARRAY_FIELDS:
        tensor = _as_tensor(getattr(batch, name))
        dtype = tensor.dtype
        if name in _INDEX_FIELDS:
            dtype = torch.int64
        elif wire is not None and name in _WIRE_FIELDS \
                and tensor.is_floating_point():
            dtype = wire
        if device.type == "cuda":
            pinned = torch.empty(tensor.shape, dtype=dtype, pin_memory=True)
            tensor = pinned.copy_(tensor).to(device, non_blocking=True)
        else:
            tensor = tensor.to(dtype).to(device)   # itself when no cast
        out[name] = tensor
    return out
