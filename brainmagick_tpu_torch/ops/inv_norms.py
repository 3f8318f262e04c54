"""Per-row inverse norms of a candidate block, in one pass.

``inv_norms(block)`` computes ``1 / (1e-8 + sqrt(sum(x^2)))`` over each
row of a [N, ...] fp32, bf16 or int8 block flattened to [N, K], summed in
fp32, as [N] fp32: the values of ``losses.block_inv_norms``, an all-zero
row's 1e8 included. On a CUDA tensor it launches the hand-written kernel
of ``csrc/inv_norms.cu``, which reads the block once (design note there);
on a CPU tensor it runs the plain version, ``_reference_impl``. It has no
gradient: the scoring sites need none, and the training loss keeps
``losses.block_inv_norms``. The wrapper calls the
custom op ``torch.ops.brainmagick.inv_norms``, whose fake implementation
gives ``torch.export`` the output's shape, so an exported scorer keeps the
op and, called on the card, launches the kernel.
"""

from __future__ import annotations

import functools

import torch

from . import _build

#: the kernel's type codes (csrc/inv_norms.cu)
TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: blocks of 256 threads an H100 SM holds at once (the kernel's register
#: cap, RESIDENT in csrc/inv_norms.cu)
RESIDENT_BLOCKS = 8
#: bytes of a row one block takes at least when rows are split: two
#: rounds of the block's 256 threads x 4 loads of 16 bytes
MIN_SPLIT_BYTES = 32 * 1024


def _reference_impl(x2: torch.Tensor) -> torch.Tensor:
    """Plain version: ``block_inv_norms``' arithmetic, without its
    gradient guard at a zero row (the values are the same)."""
    cf = x2.float()
    return 1 / (1e-8 + torch.sqrt(torch.sum(cf * cf, dim=1)))


@functools.lru_cache(maxsize=256)
def plan_splits(n: int, k: int, elem_bytes: int, n_sms: int) -> int:
    """Blocks of the kernel that share one of `n` rows of `k` elements:
    one a row once the rows fill every SM's RESIDENT_BLOCKS, else as many
    as fill them, each taking at least MIN_SPLIT_BYTES of its row."""
    wanted = -(-n_sms * RESIDENT_BLOCKS // max(n, 1))
    return max(1, min(wanted, k * elem_bytes // MIN_SPLIT_BYTES))


def _inv_norms(x2: torch.Tensor) -> torch.Tensor:
    """The custom op's implementation: the checks, then the kernel for a
    CUDA tensor (counted in ``inv_norms.launches``) or the plain version
    for a CPU one."""
    if x2.dim() != 2:
        raise ValueError(f"inv_norms needs [N, K], got {tuple(x2.shape)}")
    if x2.dtype not in TYPES:
        raise TypeError(f"inv_norms takes fp32, bf16 or int8, got "
                        f"{x2.dtype}")
    if x2.device.type == "cpu":
        return _reference_impl(x2)
    _check_device(x2)
    if not x2.is_contiguous():
        raise ValueError("inv_norms needs a contiguous block")
    n, k = x2.shape
    out = torch.empty(n, dtype=torch.float32, device=x2.device)
    if n == 0:
        return out
    n_sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    splits = plan_splits(n, k, x2.element_size(), n_sms)
    partial = (torch.empty((n, splits), dtype=torch.float32,
                           device=x2.device) if splits > 1 else None)
    with torch.cuda.device(x2.device):
        status = _build.library().bm_inv_norms(
            x2.data_ptr(), TYPES[x2.dtype],
            None if partial is None else partial.data_ptr(), out.data_ptr(),
            n, k, splits, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check_status("inv_norms", status)
    inv_norms.launches += 1
    return out


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"inv_norms runs on cpu or cuda, not {x.device}")


#: the registered op: ``torch.export`` records it by this name, which
#: saved artifacts keep
OP = torch.library.custom_op(
    "brainmagick::inv_norms", _inv_norms, mutates_args=(),
    schema="(Tensor x) -> Tensor")


@OP.register_fake
def _(x):
    return x.new_empty(x.shape[:1], dtype=torch.float32)


def inv_norms(block: torch.Tensor) -> torch.Tensor:
    """[N, ...] fp32, bf16 or int8 -> [N] fp32 inverse norms of its rows
    flattened, through the registered op (``OP``), which ``torch.export``
    keeps in its graph: its checks run in the op, where no symbolic size
    meets them."""
    _check_device(block)
    return OP(block.flatten(1))


#: kernel launches since the last reset (the CPU path does not count)
inv_norms.launches = 0
