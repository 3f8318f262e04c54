"""Top-singular-value penalty on the model's conv and dense weights.

Port of ``brainmagick_tpu/svd.py``: the squared largest singular value of
every large enough weight matrix, estimated by randomized subspace
iteration, summed. The matrices are the JAX package's: its
``iter_weight_matrices`` walks the flax parameter tree in sorted-path
order and takes each leaf named ``kernel`` with two axes or more, in
flax's layout (out-channels last, moved first, the rest flattened). The
port reads each weight under its flax path and in flax's layout through
the weight bridge's rules (``convert.model_rules``), so the same
matrices come in the same order and layout. The starting block of matrix
k is drawn from a CPU ``torch.Generator`` seeded ``1234 + k``: the same
block at every step (the JAX step draws it from ``PRNGKey(1234 + k)``
inside the jitted step, a constant too). Gradients flow through the QR
steps and the SVD.
"""

from __future__ import annotations

import random
import typing as tp

import torch
from torch import nn

from .convert import model_rules

#: the host RNG of ``proba`` < 1 (a skipped step adds 0)
penalty_rng = random.Random(1234)


def _flax_layout(kind: str, weight: torch.Tensor) -> torch.Tensor:
    """A port weight in flax's layout, the inverse of
    ``convert._untransform`` (differentiable)."""
    if kind == "conv_w":                  # [O, I/g, k] -> [k, I/g, O]
        return weight.permute(2, 1, 0)
    if kind == "convT_w":                 # [I, O, k] -> flipped [k, I, O]
        return weight.flip(2).permute(2, 0, 1)
    if kind == "convT_w_as_conv":
        return weight.permute(2, 0, 1)
    if kind == "dense_w":                 # [O, I] -> [I, O]
        return weight.t()
    return weight


def flax_kernels(model: nn.Module
                 ) -> tp.List[tp.Tuple[tp.Tuple[str, ...], torch.Tensor]]:
    """(flax path, weight in flax's layout) of each of `model`'s
    parameters that flax names ``kernel``, in sorted-path order (the
    order of ``jax.tree_util.tree_flatten`` over ``params["model"]``)."""
    kernels = [(fpath[1:], _flax_layout(kind, model.get_parameter(tkey)))
               for tkey, fpath, kind, coll in model_rules(model)
               if coll == "params" and fpath[-1] == "kernel"]
    return sorted(kernels, key=lambda item: item[0])


def iter_weight_matrices(model: nn.Module, min_size_kb: float = 1.
                         ) -> tp.Iterator[torch.Tensor]:
    """The JAX package's matrices of `model`: each kernel of two axes or
    more holding at least ``min_size_kb * 2**8`` elements (a count of
    elements, as in the JAX package), out-channels moved first."""
    for _, leaf in flax_kernels(model):
        if leaf.dim() < 2 or leaf.numel() / 2 ** 8 < min_size_kb:
            continue
        yield leaf.movedim(-1, 0)


#: the constant starting blocks, by (k, n, width, dtype, device)
_START: tp.Dict[tuple, torch.Tensor] = {}


def start_block(k: int, n: int, dim: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Matrix k's starting block [n, min(dim, n)]: normal draws from a CPU
    generator seeded ``1234 + k``, kept on `device` after the first call."""
    key = (k, n, dim, dtype, torch.device(device))
    if key not in _START:
        gen = torch.Generator().manual_seed(1234 + k)
        _START[key] = torch.randn((n, min(dim, n)), generator=gen).to(
            dtype=dtype, device=device)
    return _START[key]


def _top_singular_sq(mat: torch.Tensor, q: torch.Tensor,
                     niters: int = 2) -> torch.Tensor:
    """sigma_max(mat)^2 by `niters` QR steps of subspace iteration from
    `q` [n, d], then the top singular value of ``mat @ q``."""
    for _ in range(niters):
        q, _ = torch.linalg.qr(mat.T @ (mat @ q))
    return torch.linalg.svdvals(mat @ q)[0] ** 2


def svd_penalty(model: nn.Module, min_size: float = 1., dim: int = 16,
                niters: int = 2, proba: float = 1., exact: bool = False,
                rng: tp.Optional[tp.Any] = None,
                starts: tp.Optional[tp.Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """The sum of sigma_max^2 over ``iter_weight_matrices(model,
    min_size)``, divided by `proba`; 0 when `rng` (``penalty_rng`` when
    None) draws above `proba`. `exact` takes each matrix's exact top
    singular value; otherwise matrix k starts from ``starts[k]`` when
    given (the tests pass the JAX package's draws), else from
    ``start_block``."""
    rng = rng or penalty_rng
    device = next(model.parameters()).device
    total = torch.zeros((), device=device)
    if rng.random() > proba:
        return total
    for k, w in enumerate(iter_weight_matrices(model, min_size)):
        mat = w.reshape(w.shape[0], -1)
        if exact:
            total = total + torch.linalg.svdvals(mat)[0] ** 2
            continue
        q = starts[k] if starts is not None else start_block(
            k, mat.shape[1], dim, mat.dtype, mat.device)
        total = total + _top_singular_sq(mat, q, niters)
    return total / proba
