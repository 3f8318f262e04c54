"""Flattened A @ B^T for retrieval scoring.

Port of ``brainmagick_tpu/ops/pallas_matmul.py``: ``nt_matmul(a, b)``
computes ``[M, K] x [N, K] -> [M, N]`` in fp32 with fp32 accumulation,
over fp32, bf16 or mixed operands (``a`` is cast to ``b.dtype``). On a
CUDA tensor it launches the hand-written split-K GEMM of
``csrc/nt_matmul.cu`` (the design note is in that file); on a CPU tensor
it runs the plain version, ``_reference_impl``.
"""

from __future__ import annotations

import torch

from . import _build

#: output tile of the CUDA kernel (BM = BN) and its K step
_TILE = 64
_BK = 32
#: blocks in flight per SM that the split-K factor aims for
_BLOCKS_PER_SM = 4


def _reference_impl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16 operands are upcast first (exact), so the
    product accumulates and returns in fp32 as the kernel does."""
    return a.float() @ b.float().T


def split_k(m: int, n: int, k: int, n_sms: int) -> tuple:
    """(splits, k_chunk): split K so that about `_BLOCKS_PER_SM` blocks
    per SM are in flight; k_chunk is a multiple of the K step."""
    tiles = -(-m // _TILE) * -(-n // _TILE)
    k_steps = max(1, -(-k // _BK))
    splits = max(1, min(k_steps, -(-_BLOCKS_PER_SM * n_sms // tiles)))
    k_chunk = -(-k_steps // splits) * _BK
    return -(-k // k_chunk) if k else 1, k_chunk


def nt_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] x [N, K] -> [M, N] fp32 (A @ B^T)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"nt_matmul needs [M, K] x [N, K], got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"nt_matmul takes fp32 or bf16, got {b.dtype}")
    if a.dtype != b.dtype:
        # mixed operands (fp32 predictions vs a bf16 pool): the small
        # operand pays the cast, as in the JAX function
        a = a.to(b.dtype)
    if a.device.type == "cpu":
        return _reference_impl(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"nt_matmul runs on cpu or cuda, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("nt_matmul needs contiguous operands")
    m, k = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out.zero_()
    n_sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits, k_chunk = split_k(m, n, k, n_sms)
    workspace = (torch.empty((splits, m, n), dtype=torch.float32,
                             device=a.device) if splits > 1 else out)
    lib = _build.library()
    with torch.cuda.device(a.device):
        status = lib.bm_nt_matmul(
            a.data_ptr(), b.data_ptr(), int(b.dtype == torch.bfloat16),
            workspace.data_ptr(), out.data_ptr(), m, n, k, splits, k_chunk,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_status("nt_matmul", status)
    nt_matmul.launches += 1
    return out


#: kernel launches since the last reset (the CPU path does not count)
nt_matmul.launches = 0
