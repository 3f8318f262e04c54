"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .matmul import nt_matmul  # noqa
from .norm import normalize_clamp_peak  # noqa

#: every kernel wrapper on the serving path (each carries `.launches`)
KERNELS = (normalize_clamp_peak, nt_matmul)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
