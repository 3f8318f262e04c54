"""Hand-written Hopper kernels, each beside its plain PyTorch version."""

from .conv_bn import conv_stats  # noqa
from .matmul import nt_matmul  # noqa
from .norm import normalize_clamp_peak  # noqa

#: every kernel wrapper of the port (each carries `.launches`)
KERNELS = (normalize_clamp_peak, nt_matmul, conv_stats)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
