"""Configuration of the port: the JAX package's config fields that its
paths read, and the XP signature rule.

The fields (names, defaults and the ``clip_conv``, ``clip_conv_tpu``,
``tiny``, ``deep_mel``, ``convrnn`` and ``decoder_convrnn`` presets) are
copies of ``brainmagick_tpu.config``'s, so that the port runs on a host
that has no JAX package (tests/test_torch_serve.py holds the copy to the
original). Two differences: ``device`` defaults to ``"cuda"`` (the JAX
package's ``"tpu"``), and the mesh and sharding fields of ``parallel``
and the other presets are not copied. ``delta``/``sig`` follow
the JAX package's rule (the hash of the non-default fields, cosmetic keys
excluded), so the same overrides give the same signature in both
packages. Every function of the port
that takes `args` accepts the JAX package's ``MainConfig`` as well.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import typing as tp
from dataclasses import dataclass, field
from pathlib import Path


def _dict(**kwargs: tp.Any) -> tp.Any:
    return field(default_factory=lambda: copy.deepcopy(kwargs))


def _list(*items: tp.Any) -> tp.Any:
    return field(default_factory=lambda: list(items))


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

#: brainmagick_tpu.config.CONVRNN_DEFAULTS
CONVRNN_DEFAULTS: tp.Dict[str, tp.Any] = dict(
    concatenate=False, depth=2, linear_out=False, complex_out=False,
    kernel_size=4, stride=2, growth=1., lstm=4, bidirectional_lstm=False,
    flip_lstm=False, attention=0, heads=4, conv_dropout=0.0,
    lstm_dropout=0.0, dropout_input=0.0, batch_norm=False,
    relu_leakiness=0.0, subject_dim=64, embedding_location=("lstm",),
    embedding_scale=1.0, subject_layers=False, subject_layers_dim="input")


@dataclass
class OptimConfig:
    name: str = "adam"
    lr: float = 3e-4
    beta2: float = 0.999
    epochs: int = 40
    batch_size: int = 32
    loss: str = "l1"
    use_weighting: bool = False
    max_batches: tp.Optional[int] = None
    svd: float = 0.
    negatives: tp.Optional[int] = None
    negative_pool_size: tp.Optional[int] = None


@dataclass
class ClipConfig:
    linear: tp.Optional[int] = None
    twin: bool = True
    pool: bool = False
    tmin: tp.Optional[float] = None
    tmax: tp.Optional[float] = None
    tmin_train: tp.Optional[float] = None
    tmax_train: tp.Optional[float] = None
    center: bool = False
    save_best: bool = True
    sync_grad: bool = False
    compute_dtype: tp.Optional[str] = None


@dataclass
class TestEvalConfig:
    wer_negatives: int = 10_000
    wer_topx: int = 10
    wer_random: bool = False
    wer_recordings: int = 40
    wer_study: tp.Optional[str] = None
    pool_int8: bool = False


@dataclass
class DsetTestOverride:
    tmin: tp.Optional[float] = None
    tmax: tp.Optional[float] = None
    condition: tp.Optional[tp.Union[str, float]] = "word"


@dataclass
class DsetConfig:
    selections: tp.List[str] = _list("gwilliams2022")
    tmin: float = -0.5
    tmax: float = 2.5
    n_recordings: int = 1000
    n_subjects: tp.Optional[int] = None
    n_subjects_test: tp.Optional[int] = None
    shuffle_recordings_seed: int = -1
    skip_recordings: int = 0
    test_ratio: float = 0.2
    valid_ratio: float = 0.1
    remove_ratio: float = 0.
    condition: tp.Union[str, float] = 0.5
    apply_baseline: bool = True
    min_block_duration: float = 6.
    force_uid_assignement: bool = False
    min_n_blocks_per_split: int = 1
    ignore_end_in_block: bool = False
    ignore_start_in_block: bool = False
    sample_rate: int = 120
    highpass: float = 0.
    event_mask: bool = True
    split_wav_as_block: bool = True
    allow_empty_split: bool = False
    autoreject: bool = False
    test: DsetTestOverride = field(default_factory=DsetTestOverride)
    features: tp.List[str] = _list("Wav2VecTransformer")
    extra_test_features: tp.List[str] = field(default_factory=list)
    features_params: tp.Dict[str, tp.Any] = _dict(
        MelSpectrum=dict(n_fft=512, n_mels=120, normalized=True,
                         use_log_scale=True, log_scale_eps=1e-5),
        Pitch=dict(min_f0=100, max_f0=350),
        WordHash=dict(buckets=100000),
        XlmEmbedding=dict(contextual=False),
        WordEmbedding=dict(lang="auto"),
        WordEmbeddingSmall=dict(lang="auto"),
        PartOfSpeech=dict(lang="auto"),
        Wav2VecTransformer=dict(layers=[14, 15, 16, 17, 18], device="cpu",
                                random=False),
        Wav2VecChunk=dict(device="cpu"),
    )


@dataclass
class ScalerConfig:
    per_channel: bool = False
    n_samples_per_recording: int = 200
    n_samples_features: tp.Optional[int] = 8000


@dataclass
class NormConfig:
    scaler: ScalerConfig = field(default_factory=ScalerConfig)
    max_scale: float = 20.
    clip: bool = True
    exclude_empty_features: bool = False


@dataclass
class TaskConfig:
    type: str = "decode"
    meg_init: float = 0.3
    lowpass: float = 0.
    offset_meg_ms: float = 0.
    lowpass_gt: bool = True
    lowpass_gt_test: bool = False
    mask_loss: bool = False


@dataclass
class ParallelConfig:
    """``brainmagick_tpu.config.ParallelConfig`` for data-parallel runs
    over the cards of one host (``parallel``: one process a card under
    ``python -m torch.distributed.run``). ``data_axis`` and
    ``donate_state`` (a mesh axis and a buffer donation of the JAX step)
    are accepted and read by nothing; ``scoped_vmem_limit_kib`` and
    ``compilation_cache`` (XLA's) are not copied."""
    data_axis: str = "data"
    #: contrastive candidates stay within contiguous groups of this many
    #: ranks: 1 = each rank's own rows (the reference's per-GPU pools),
    #: k = the rows of a group of k ranks gathered, 0 = every rank's rows.
    #: Must divide the number of ranks
    negatives_group_size: int = 1
    #: the train CLI joins the launcher's ranks
    #: (``python -m torch.distributed.run``) into one data-parallel run;
    #: with several ranks it cannot be turned off (each rank would train
    #: the whole batch alone)
    auto_mesh: bool = True
    #: accepted: the train CLI always reads the launcher's environment
    distributed_init: bool = False
    donate_state: bool = True
    #: cast meg/features to this dtype on the host before the copy to the
    #: card (``dataset.to_device``): 'bfloat16' halves the bytes, and the
    #: compute upcasts on the card
    transfer_dtype: tp.Optional[str] = None
    #: the test stage's and the evaluation's retrieval scores with the
    #: candidate pool split over the ranks and passed around their ring
    #: (``losses.ring_scores``) instead of streamed whole to every rank;
    #: not for a pool past the per-rank budget, nor for a configuration
    #: with a trim window or a transform
    ring_scoring: bool = False
    #: with negatives_group_size k > 1, pass each rank's candidate rows
    #: around its group's ring one hop at a time, each block scored as it
    #: arrives, instead of gathering the group's rows at once: the same
    #: loss and gradients, candidate memory of one rank's rows
    ring_negatives: bool = False
    #: the dtype the train and valid loaders assemble meg and features
    #: in, in their pinned buffers on a CUDA device (``loader.Loader``)
    assemble_dtype: tp.Optional[str] = None


@dataclass
class MainConfig:
    num_prints: int = 5
    #: "cuda" (the default) or "cpu": where the model, the preprocessing
    #: and the steps run
    device: str = "cuda"
    num_workers: int = 2
    verbose: int = 0
    show: int = 0
    download_only: bool = False
    wandb: tp.Dict[str, tp.Any] = _dict(
        use_wandb=False, project="brainmagick_tpu",
        group="brainmagick-group")
    tensorboard: bool = False
    profile: bool = False
    continue_sig: tp.Optional[str] = None
    continue_best: bool = True
    seed: int = 2036
    dummy: tp.Optional[str] = None
    cache: tp.Optional[str] = "./cache"
    feature_models: tp.Optional[str] = "./features_models"
    early_stop_patience: int = 10
    checkpoint_async: bool = True
    eval_every: int = 1
    eval_train_set: bool = False
    out_dir: str = "./outputs"
    model_name: str = "simpleconv"
    feature_model_name: tp.Optional[str] = None
    feature_model_params: tp.Dict[str, tp.Any] = field(default_factory=dict)
    override_n_subjects_model: tp.Optional[int] = None
    simpleconv: tp.Dict[str, tp.Any] = field(
        default_factory=lambda: copy.deepcopy(SIMPLECONV_DEFAULTS))
    convrnn: tp.Dict[str, tp.Any] = field(
        default_factory=lambda: copy.deepcopy(CONVRNN_DEFAULTS))
    optim: OptimConfig = field(default_factory=OptimConfig)
    clip: ClipConfig = field(default_factory=ClipConfig)
    test: TestEvalConfig = field(default_factory=TestEvalConfig)
    dset: DsetConfig = field(default_factory=DsetConfig)
    norm: NormConfig = field(default_factory=NormConfig)
    task: TaskConfig = field(default_factory=TaskConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    selections: tp.Dict[str, tp.Dict[str, tp.Any]] = _dict(
        audio_mous=dict(study="schoffelen2019", modality="audio"),
        audio_mous_wl=dict(study="schoffelen2019", modality="audio",
                           events_filter='condition == "word_list"'),
        visual_mous=dict(study="schoffelen2019", modality="visual"),
        gwilliams2022=dict(study="gwilliams2022"),
        broderick2019=dict(study="broderick2019"),
        brennan2019=dict(study="brennan2019"),
        fake=dict(study="fake"),
        fakeeeg=dict(study="fakeeeg"),
    )

    #: keys excluded from the signature (cosmetic, as in the JAX package)
    _SIG_EXCLUDE = ("num_prints", "device", "num_workers", "verbose",
                    "cache", "feature_models", "show", "out_dir",
                    "download_only", "wandb", "tensorboard", "profile",
                    "checkpoint_async")

    def delta(self) -> tp.Dict[str, tp.Any]:
        """Non-default config fields (flat dotted keys)."""
        return _diff(dataclasses.asdict(self),
                     dataclasses.asdict(MainConfig()),
                     exclude=self._SIG_EXCLUDE)

    @property
    def sig(self) -> str:
        """The XP signature: a hash of ``delta()``."""
        payload = json.dumps(self.delta(), sort_keys=True, default=str)
        return hashlib.sha1(payload.encode()).hexdigest()[:8]

    @property
    def xp_folder(self) -> Path:
        return Path(self.out_dir) / "xps" / self.sig


#: marker for "this dict key was removed relative to the default config"
DELETED = "__deleted__"


def _diff(cfg: tp.Any, default: tp.Any, prefix: str = "",
          exclude: tp.Tuple[str, ...] = ()) -> tp.Dict[str, tp.Any]:
    out: tp.Dict[str, tp.Any] = {}
    if isinstance(cfg, dict) and isinstance(default, dict):
        for key in sorted(set(cfg) | set(default), key=str):
            dotted = f"{prefix}{key}"
            if dotted in exclude:
                continue
            if key not in cfg:
                out[dotted] = DELETED
                continue
            out.update(_diff(cfg.get(key), default.get(key), dotted + ".",
                             exclude))
        return out
    if cfg != default:
        out[prefix[:-1]] = cfg
    return out


def apply_preset(cfg: MainConfig, name: str) -> MainConfig:
    """The ``clip_conv`` preset (the paper recipe), ``clip_conv_tpu``
    (the paper recipe with bf16 compute, estimates and scores, no
    BatchNorm-cancelled conv biases, the fused head, tanh GELU and the
    bf16 wire), ``clip_conv_v5e8`` and ``clip_conv_v5e8_paper`` (that
    recipe over 8 cards: a local batch of 256 and per-card pools, or the
    paper's global batch of 256 in pools of 4 cards), ``tiny`` (a
    CPU-sized SimpleConv), ``deep_mel`` (the
    DeepMel feature model on the ground truth, Table 2's "MelSpectrum +
    DeepMel" cell), ``convrnn`` (the encode task: a ConvRNN predicts the
    MEG from the features and a MEG prompt, under an L1 loss) or
    ``decoder_convrnn`` (a bidirectional ConvRNN decoding the word
    segments) or ``none`` (no feature model), on the copied fields."""
    if name == "clip_conv_tpu":
        apply_preset(cfg, "clip_conv")
        cfg.simpleconv.update(dtype="bfloat16", output_dtype="bfloat16",
                              bn_conv_bias=False, fused_head=True,
                              gelu_exact=False)
        cfg.clip.compute_dtype = "bfloat16"
        cfg.parallel.transfer_dtype = "bfloat16"
        cfg.parallel.assemble_dtype = "bfloat16"
        return cfg
    if name == "clip_conv_v5e8":
        # weak scaling: each of 8 cards keeps the recipe's local batch of
        # 256 (global 2048) and a per-card pool of 256 candidates
        apply_preset(cfg, "clip_conv_tpu")
        cfg.optim.batch_size = 2048
        cfg.parallel.negatives_group_size = 1
        cfg.optim.lr = cfg.optim.lr * 2
        return cfg
    if name == "clip_conv_v5e8_paper":
        # the paper's global batch of 256 on 8 cards: groups of 4 cards x
        # 32 rows rebuild the two 128-candidate pools of its 2 GPUs,
        # passed around each group's ring
        apply_preset(cfg, "clip_conv_tpu")
        cfg.optim.batch_size = 256
        cfg.parallel.negatives_group_size = 4
        cfg.parallel.ring_negatives = True
        return cfg
    if name == "tiny":
        cfg.simpleconv.update(
            hidden=24, depth=2, kernel_size=3, dilation_period=2,
            skip=True, glu=2, glu_context=1, merger=True,
            merger_channels=16, merger_pos_dim=32, initial_linear=16,
            gelu=True, batch_norm=True, subject_layers=True,
            subject_dim=0, complex_out=True)
        cfg.optim.batch_size = 8
        return cfg
    if name == "deep_mel":
        cfg.feature_model_name = "deep_mel"
        cfg.feature_model_params = dict(
            n_hidden_channels=320, n_hidden_layers=10, n_out_channels=768,
            kernel=3, stride=1, dilation_growth=2, dilation_period=5,
            batch_norm=True, activation_on_last=False, skip=True,
            glu_context=1, glu=2)
        return cfg
    if name == "convrnn":
        cfg.model_name = "convrnn"
        cfg.convrnn["hidden"] = dict(meg=512, features=12)
        cfg.task.type = "encode"
        cfg.optim.loss = "l1"
        return cfg
    if name == "decoder_convrnn":
        cfg.model_name = "convrnn"
        cfg.convrnn["hidden"] = dict(meg=512)
        cfg.convrnn["bidirectional_lstm"] = True
        cfg.dset.features = ["WordSegment"]
        cfg.optim.loss = "regression_classification"
        cfg.task.type = "decode"
        return cfg
    if name == "none":
        cfg.feature_model_name = None
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
