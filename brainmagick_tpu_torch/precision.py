"""fp32 that means fp32 on the card, and the JAX package's compute dtypes.

torch lets cuDNN run fp32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True; the cuBLAS flag
``torch.backends.cuda.matmul.allow_tf32`` is False), which keeps about
three decimal digits. The port's contract is the JAX package's fp32, and
its own kernels run fp32 products as 3xTF32, so the entry points
(``Server.forward_batch``, ``Server.probabilities``, ``Solver.step``) run
inside ``exact_fp32``.

The backward of a training step (``Solver.loss_and_grad``) runs inside
``deterministic_cudnn``: cuDNN's default choice of algorithm for the
encoder's convolution gradients sums with atomics, so two runs of the
same step on the same card differ in their last bits (the JAX package's
step on a TPU gives the same bits each time), and over a few steps a
ranking metric such as the test WER can flip.

A compute dtype (``simpleconv.dtype``, ``clip.compute_dtype``) is named
by a string, as in the JAX package's config (``torch_dtype``). Where the
JAX package contracts operands of that dtype with an fp32 accumulator and
an fp32 result (``preferred_element_type=float32``), the port calls
``einsum_fp32``: a bf16 ``torch.einsum`` would round its result to bf16.
"""

from __future__ import annotations

import contextlib
import typing as tp

import torch


def torch_dtype(name: tp.Any) -> tp.Optional[torch.dtype]:
    """A config's dtype name ('bfloat16', 'float32'), or a torch dtype,
    as a torch dtype; None stays None."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def einsum_fp32(equation: str, *operands: torch.Tensor,
                dtype: tp.Optional[torch.dtype] = None) -> torch.Tensor:
    """``jnp.einsum(equation, *operands, preferred_element_type=float32)``
    on operands cast to `dtype`: each operand rounded to `dtype` (when
    given), then contracted in fp32. The products of bf16 values are exact
    in fp32, so this is a bf16 contraction with an fp32 accumulator and an
    fp32 result; on the card it runs as fp32 (exact inside
    ``exact_fp32``). Float64 operands stay float64."""
    if dtype is not None:
        operands = tuple(op.to(dtype) for op in operands)
    return torch.einsum(equation, *(
        op.to(torch.promote_types(op.dtype, torch.float32))
        for op in operands))


@contextlib.contextmanager
def exact_fp32() -> tp.Iterator[None]:
    """Turn off TF32 in cuBLAS and cuDNN, and restore both flags on exit
    (also when the body raises). Usable as a decorator.

    The flags are process-wide in torch, not per thread: while the body
    runs they hold for every thread of the process, the autograd engine's
    device threads included (so a ``backward()`` in the body runs its
    cuDNN calls without TF32), and a thread that sets them meanwhile
    changes them for the body too."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    previous = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = previous


@contextlib.contextmanager
def deterministic_cudnn() -> tp.Iterator[None]:
    """Let cuDNN choose only deterministic algorithms
    (``torch.backends.cudnn.deterministic``), and restore the flag on exit
    (also when the body raises). Usable as a decorator; process-wide, as
    ``exact_fp32``'s flags are."""
    cudnn = torch.backends.cudnn
    previous = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = previous
