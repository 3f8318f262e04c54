"""fp32 that means fp32 on the card.

torch lets cuDNN run fp32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True; the cuBLAS flag
``torch.backends.cuda.matmul.allow_tf32`` is False), which keeps about
three decimal digits. The port's contract is the JAX package's fp32, and
its own kernels run fp32 products as 3xTF32, so the entry points
(``Server.forward_batch``, ``Server.probabilities``, ``Solver.step``) run
inside ``exact_fp32``.
"""

from __future__ import annotations

import contextlib
import typing as tp

import torch


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
