"""brainmagick_tpu_torch: the PyTorch/CUDA port of brainmagick_tpu.

Three slices run the paper model on one NVIDIA H100. Serving
(``serve.Server``): per-recording normalization (a CUDA kernel that
gathers each sample's recording tables itself), the SimpleConv decoder in
eval mode, and CLIP retrieval scoring (a CUDA GEMM). Training
(``train.Trainer``): the same normalization, the decoder in train mode
with each encoder conv and its BatchNorm sums in one CUDA kernel
(``fused_conv_bn``), the CLIP loss, backward and Adam. Offline evaluation
(``eval.run_eval``, ``wer.get_wer``): the server's forwards, then every
prediction scored against a candidate pool streamed to the card in
blocks (the same GEMM), top-k segment accuracy and word-retrieval error.
The entry points run fp32 with TF32 off (``precision.exact_fp32``), or
the ``clip_conv_tpu`` recipe's bf16 where the config asks for it
(``models.common`` says where each op casts).
The JAX package ``brainmagick_tpu`` stays the reference; the tests hold
this package to it on the same inputs and bridged weights
(``convert.load_jax_params``).

The package imports torch, numpy and the standard library only; kernels
are built from ``csrc/`` and ``ops/`` at first use on a CUDA device.
"""

__version__ = "0.1.0"
