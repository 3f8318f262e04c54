"""brainmagick_tpu_torch: the PyTorch/CUDA port of brainmagick_tpu.

Two slices run the paper model on one NVIDIA H100. Serving
(``serve.Server``): per-recording normalization (a Triton kernel), the
SimpleConv decoder in eval mode, and CLIP retrieval scoring (a CUDA
split-K GEMM). Training (``train.Trainer``): the same normalization, the
decoder in train mode with each encoder conv and its BatchNorm sums in
one CUDA kernel (``fused_conv_bn``), the CLIP loss, backward and Adam.
The JAX package ``brainmagick_tpu`` stays the reference; the tests hold
this package to it on the same inputs and bridged weights
(``convert.load_jax_params``).

The package imports torch, numpy and the standard library only; kernels
are built from ``csrc/`` and ``ops/`` at first use on a CUDA device.
"""

__version__ = "0.1.0"
