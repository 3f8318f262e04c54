"""Configuration of the serving, training and evaluation slices.

The fields the port reads, with the names, defaults and the ``clip_conv``
and ``clip_conv_tpu`` presets of ``brainmagick_tpu.config``, copied so
that the port runs on a host that has no JAX package
(tests/test_torch_serve.py holds the copy to the original). Every
function of the port that takes `args` accepts the JAX package's
``MainConfig`` as well.
"""

from __future__ import annotations

import copy
import typing as tp
from dataclasses import dataclass, field

#: brainmagick_tpu.config.SIMPLECONV_DEFAULTS
SIMPLECONV_DEFAULTS: tp.Dict[str, tp.Any] = dict(
    concatenate=False, depth=4, linear_out=False, complex_out=False,
    kernel_size=5, dilation_growth=2, dilation_period=None, skip=False,
    post_skip=False, growth=1., scale=None, rewrite=False, groups=1,
    glu=0, glu_context=0, glu_glu=True, gelu=False, dual_path=0,
    conv_dropout=0.0, dropout_input=0.0, batch_norm=False,
    relu_leakiness=0.0, subject_dim=64, subject_layers=False,
    embedding_scale=1.0, subject_layers_dim="input",
    subject_layers_id=False, n_fft=None, fft_complex=True, merger=False,
    merger_pos_dim=256, merger_channels=270, merger_dropout=0.2,
    merger_penalty=0., merger_per_subject=False, dropout=0.,
    dropout_rescale=True, initial_linear=0, initial_depth=1,
    initial_nonlin=False, subsample_meg_channels=0,
    dtype=None, output_dtype=None, output_layout="bct", conv_impl="conv",
    bn_conv_bias=True, fused_conv_bn=False, fused_head=False,
    gelu_exact=True)


@dataclass
class OptimConfig:
    name: str = "adam"
    lr: float = 3e-4
    beta2: float = 0.999
    epochs: int = 40
    batch_size: int = 32
    loss: str = "l1"
    max_batches: tp.Optional[int] = None
    svd: float = 0.
    negatives: tp.Optional[int] = None


@dataclass
class ClipConfig:
    linear: tp.Optional[int] = None
    pool: bool = False
    tmin: tp.Optional[float] = None
    tmax: tp.Optional[float] = None
    tmin_train: tp.Optional[float] = None
    tmax_train: tp.Optional[float] = None
    center: bool = False
    compute_dtype: tp.Optional[str] = None


@dataclass
class TestEvalConfig:
    wer_negatives: int = 10_000
    wer_topx: int = 10
    wer_random: bool = False
    pool_int8: bool = False


@dataclass
class DsetTestOverride:
    tmin: tp.Optional[float] = None


@dataclass
class DsetConfig:
    tmin: float = -0.5
    sample_rate: int = 120
    test: DsetTestOverride = field(default_factory=DsetTestOverride)


@dataclass
class NormConfig:
    max_scale: float = 20.
    clip: bool = True
    exclude_empty_features: bool = False


@dataclass
class TaskConfig:
    type: str = "decode"
    lowpass: float = 0.
    offset_meg_ms: float = 0.
    mask_loss: bool = False


@dataclass
class ParallelConfig:
    """The wire-format fields of ``brainmagick_tpu.config.ParallelConfig``
    (the mesh and sharding fields are not ported)."""
    #: cast meg/features to this dtype on the host before the copy to the
    #: card (``dataset.to_device``): 'bfloat16' halves the bytes, and the
    #: compute upcasts on the card
    transfer_dtype: tp.Optional[str] = None
    #: the dtype the native host gather assembles batches in; copied for
    #: the presets, and read nowhere until the port has a data path
    assemble_dtype: tp.Optional[str] = None


@dataclass
class MainConfig:
    seed: int = 2036
    model_name: str = "simpleconv"
    feature_model_name: tp.Optional[str] = None
    simpleconv: tp.Dict[str, tp.Any] = field(
        default_factory=lambda: copy.deepcopy(SIMPLECONV_DEFAULTS))
    optim: OptimConfig = field(default_factory=OptimConfig)
    clip: ClipConfig = field(default_factory=ClipConfig)
    test: TestEvalConfig = field(default_factory=TestEvalConfig)
    dset: DsetConfig = field(default_factory=DsetConfig)
    norm: NormConfig = field(default_factory=NormConfig)
    task: TaskConfig = field(default_factory=TaskConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


def apply_preset(cfg: MainConfig, name: str) -> MainConfig:
    """The ``clip_conv`` preset (the paper recipe) or ``clip_conv_tpu``
    (the paper recipe with bf16 compute, estimates and scores, no
    BatchNorm-cancelled conv biases, the fused head, tanh GELU and the
    bf16 wire) on the copied fields."""
    if name == "clip_conv_tpu":
        apply_preset(cfg, "clip_conv")
        cfg.simpleconv.update(dtype="bfloat16", output_dtype="bfloat16",
                              bn_conv_bias=False, fused_head=True,
                              gelu_exact=False)
        cfg.clip.compute_dtype = "bfloat16"
        cfg.parallel.transfer_dtype = "bfloat16"
        cfg.parallel.assemble_dtype = "bfloat16"
        return cfg
    if name != "clip_conv":
        raise NotImplementedError(f"preset {name!r}")
    cfg.model_name = "simpleconv"
    cfg.simpleconv.update(
        hidden=320, batch_norm=True, depth=10, dilation_period=5,
        kernel_size=3, skip=True, subject_layers=True, subject_dim=0,
        complex_out=True, glu=2, glu_context=1, merger=True,
        initial_linear=270, gelu=True, merger_pos_dim=2048)
    cfg.optim.loss = "clip"
    cfg.optim.epochs = 200
    cfg.optim.max_batches = 1200
    cfg.optim.batch_size = 256
    cfg.norm.clip = True
    cfg.task.type = "decode"
    cfg.task.offset_meg_ms = 150
    return cfg
