"""Flattened A @ B^T for retrieval scoring.

Port of ``brainmagick_tpu/ops/pallas_matmul.py``: ``nt_matmul(a, b)``
computes ``[M, K] x [N, K] -> [M, N]`` in fp32 with fp32 accumulation,
over fp32, bf16 or mixed operands (``a`` is cast to ``b.dtype``). On a
CUDA tensor it launches the hand-written TMA + ``wgmma`` GEMM of
``csrc/nt_matmul.cu`` (bf16 as it is, fp32 as 3xTF32; the design note is
in that file); on a CPU tensor it runs the plain version,
``_reference_impl``. The wrapper calls the custom op
``torch.ops.brainmagick.nt_matmul``, whose fake implementation gives
``torch.export`` the output's shape, so an exported scorer keeps the op
and, called on the card, launches the kernel.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build

#: bank rows per CTA (two warpgroups of 64) and the prediction tile widths
#: by operand size: fp32 (3xTF32, two accumulators) stops at 128
BANK_ROWS = 128
WIDTHS = {4: (8, 64, 128), 2: (8, 64, 128, 256)}
#: bytes of K per pipeline stage: one 128-byte swizzle row
STEP_BYTES = 128
#: what one more split costs a CTA (pipeline fill, partial tile store and
#: its re-read by the split sum), in K steps
_SPLIT_COST = 4
#: TMA needs 16-byte aligned rows
_ALIGN_BYTES = 16
#: bf16 K steps one split may take. The tensor core's fp32 accumulator over
#: a bf16 chain drifts with the chain's length (on an H100 at 2048 x 2048 x
#: 351,232, random operands: 3.9e-6 of |a||b| in one chain, as cuBLAS's
#: torch.mm; 4.6e-7 over 8 splits, 2.6e-7 over 16), so a longer K is split
#: at least this finely. fp32 starts a fresh accumulator every K step.
MAX_BF16_STEPS = 512


def _reference_impl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16 operands are upcast first (exact), so the
    product accumulates and returns in fp32 as the kernel does."""
    return a.float() @ b.float().T


@functools.lru_cache(maxsize=256)
def plan_tiles(m: int, n: int, k: int, n_sms: int, elem_bytes: int
               ) -> tuple:
    """(width, bank_rows, splits, k_chunk) of the CUDA kernel for
    [m, k] x [n, k] operands of `elem_bytes` bytes.

    width is the smallest prediction tile that covers m (the widest, and
    a grid over m, above that). The K split minimizes waves x (K steps
    per split + _SPLIT_COST) over at most 8 waves of one CTA per SM, so
    the CTAs fill the SMs in whole waves, and over no fewer splits than
    keep a bf16 split within MAX_BF16_STEPS; k_chunk is a whole number of
    K steps, and every split gets at least one."""
    widths = WIDTHS[elem_bytes]
    width = next((w for w in widths if w >= m), widths[-1])
    bk = STEP_BYTES // elem_bytes
    tiles = -(-n // BANK_ROWS) * -(-m // width)
    k_steps = max(1, -(-k // bk))

    def cost(s: int) -> int:
        return -(-tiles * s // n_sms) * (-(-k_steps // s) + _SPLIT_COST)

    least = -(-k_steps // MAX_BF16_STEPS) if elem_bytes == 2 else 1
    most = max(least, min(k_steps, -(-8 * n_sms // tiles)))
    splits = min(range(least, most + 1), key=cost)
    per_split = -(-k_steps // splits)
    return width, BANK_ROWS, -(-k_steps // per_split), per_split * bk


def tma_operand(x: torch.Tensor) -> torch.Tensor:
    """`x` [rows, K] as TMA can load it: rows of a multiple of 16 bytes
    from a 16-byte aligned base. Pads K with zero columns (which add
    nothing to the product) or copies a misaligned view; returns `x`
    itself when it already qualifies."""
    multiple = _ALIGN_BYTES // x.element_size()
    pad = -x.shape[1] % multiple
    if pad:
        return F.pad(x, (0, pad))
    if x.data_ptr() % _ALIGN_BYTES:
        return x.clone()
    return x


def _nt_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The custom op's implementation: the checks, then the kernel for
    CUDA operands (counted in ``nt_matmul.launches``) or the plain version
    for CPU ones."""
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
    _check_device(a)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("nt_matmul needs contiguous operands")
    m, n = a.shape[0], b.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0 or a.shape[1] == 0:
        return out.zero_()
    a, b = tma_operand(a), tma_operand(b)
    k = a.shape[1]
    bf16 = b.dtype == torch.bfloat16
    n_sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    width, _, splits, k_chunk = plan_tiles(m, n, k, n_sms, b.element_size())
    a_split = (a if bf16 else
               torch.empty((2, m, k), dtype=torch.float32, device=a.device))
    workspace = (torch.empty((splits, m, n), dtype=torch.float32,
                             device=a.device) if splits > 1 else out)
    lib = _build.library()
    with torch.cuda.device(a.device):
        status = lib.bm_nt_matmul(
            a.data_ptr(), b.data_ptr(), int(bf16), a_split.data_ptr(),
            workspace.data_ptr(), out.data_ptr(), m, n, k, width, splits,
            k_chunk, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_status("nt_matmul", status)
    nt_matmul.launches += 1
    return out


def _check_device(a: torch.Tensor) -> None:
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nt_matmul runs on cpu or cuda, not {a.device}")


#: the registered op: ``torch.export`` records it by this name, which
#: saved artifacts keep
OP = torch.library.custom_op(
    "brainmagick::nt_matmul", _nt_matmul, mutates_args=(),
    schema="(Tensor a, Tensor b) -> Tensor")


@OP.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[0]), dtype=torch.float32)


def nt_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] x [N, K] -> [M, N] fp32 (A @ B^T), through the registered op
    (``OP``), which ``torch.export`` keeps in its graph: its checks run in
    the op, where no symbolic size meets them."""
    _check_device(a)
    return OP(a, b)


#: kernel launches since the last reset (the CPU path does not count)
nt_matmul.launches = 0
