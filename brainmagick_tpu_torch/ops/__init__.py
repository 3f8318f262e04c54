"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``normalize_clamp_peak``, ``nt_matmul`` and ``inv_norms`` are registered
custom ops of the ``brainmagick`` namespace (``torch.ops.brainmagick.*``),
which ``torch.export`` artifacts name: importing this package registers
them."""

from .. import tracing
from .conv_bn import conv_stats  # noqa
from .inv_norms import inv_norms  # noqa
from .matmul import nt_matmul  # noqa
from .norm import normalize_clamp_peak  # noqa

#: every kernel wrapper of the port (each carries `.launches`)
KERNELS = (normalize_clamp_peak, nt_matmul, conv_stats, inv_norms)


def launch_counts() -> dict:
    """The program's counters since the process started or the last
    ``reset_launch_counts``: {kernel name: its launches}, and
    ``tracing.counters()`` under their dotted names (``h2d.bytes``,
    ``loader.wait_us``, ``device_us.<span>``, ...)."""
    return {**{kernel.__name__: kernel.launches for kernel in KERNELS},
            **tracing.counters()}


def reset_launch_counts() -> None:
    """Zero the kernels' launches and routes and ``tracing``'s counters."""
    tracing.reset()
    for kernel in KERNELS:
        kernel.launches = 0
    for counts in (conv_stats.launches_by_route,
                   conv_stats.launches_by_dtype):
        counts.update(dict.fromkeys(counts, 0))
