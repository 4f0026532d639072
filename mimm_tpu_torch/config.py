"""Configuration the port shares with the JAX package (copied, not
imported): ``DatasetConfig`` and its command line
``construct_dataset_parameters`` (mimm_tpu/config.py:29-53, 443-448), the
classifier architecture, ``TrainingConfig`` with the fields the trainers
read, the ``production()`` / ``parity()`` presets (:79-373),
``PRODUCTION_SEQ_BUCKETS`` and the command line,
``construct_training_parameters`` (:397-441)."""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Sequence

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference sweep's classifier MLP architecture (mimm_tpu/config.py
# DEFAULT_CLASSIFIER_LAYERS): serving and validation must agree with the
# trainer or the checkpoint fails to load.
DEFAULT_CLASSIFIER_LAYERS = (1024, 512, 256, 128, 64, 32, 16)

# The production sequence buckets (paired-loader length classes).
PRODUCTION_SEQ_BUCKETS = (64, 96, 128, 160, 192, 256, 320)


def _default(path: str) -> str:
    return os.path.join(_REPO_DIR, path)


@dataclass(frozen=True)
class DatasetConfig:
    """Dataset download / population flags (reference helpers.py:7-82),
    read by data/etl.py and cli/dataset_populate.py."""

    download_user: str = "user"
    download_password: str = "..."
    total_amount: int = 1_000_000
    amount_for_training: int = 9_000
    amount_for_testing: int = 1_000

    data_dir: str = _default("full_data_set/")
    image_storage_dir: str = _default("full_data_set/images/")
    text_storage_dir: str = _default("full_data_set/text/")

    training_data_dir: str = _default("training_data/")
    training_image_dir: str = _default("training_data/images/")
    training_text_dir: str = _default("training_data/text/")
    training_dataset_labeldata: str = _default(
        "training_data/training_label_negbio.csv")

    testing_data_dir: str = _default("testing_data/")
    testing_image_dir: str = _default("testing_data/images/")
    testing_text_dir: str = _default("testing_data/text/")
    testing_dataset_labeldata: str = _default(
        "testing_data/testing_label_negbio.csv")

    sub_folder: str = "p10"


@dataclass(frozen=True)
class TrainingConfig:
    """Training flags (reference helpers.py:84-144) and the JAX package's
    knobs that the MI step reads, with the JAX defaults.

    The port runs: ``compute_dtype``, ``mi_estimator``, ``use_pallas_critic``
    (the critic's size switch: the pairwise-critic kernels past it),
    ``flash_attention``, ``gelu_tanh``, ``fused_ffn`` (the fused FFN kernels
    where ``gelu_tanh`` is set), ``pallas_stem`` (the stem on the
    shallow-conv kernels), ``u8_dropout``, both moment dtypes, the freezes,
    ``grad_cache_chunks`` (GradCache's two passes above 1),
    ``global_negatives``, and for a world of ranks (parallel/mesh.py)
    ``mesh_shape`` / ``dcn_mesh_shape`` (the 'data', 'model' and 'pipe'
    axes), ``pipeline_microbatches`` (GPipe's M; 0: one per stage),
    ``grad_allreduce_dtype``, ``sequence_parallel``,
    ``zero1_optimizer_sharding`` and ``fsdp_parameter_sharding``;
    ``MultiModalManager`` also reads
    the data's paths (``image_dir``, ``text_data_dir``,
    ``dataset_metadata``, ``decoded_crop_cache``), ``seq_buckets``,
    ``data_loader_workers``, ``prefetch``, ``checkpoint_every_epochs``,
    ``resume_from`` ("" | "auto" | a path), ``keep_checkpoints`` and
    ``checkpoint_format`` ("pickle", or the sharded "orbax" /
    "orbax_async", which a world of several ranks always writes); the classifier trainer and validation
    read ``dataset_disease_stats``, ``num_train_epochs_classifier``,
    ``disease_label`` and ``optimizer``.  TPU schedules it accepts because
    they give the same result: ``scan_steps`` (K steps run as a loop),
    ``rng_impl`` (masks come from torch generators), ``compact_transfer``,
    ``s2d_stem`` (the canonical stem; exclusive with ``pallas_stem``, as in
    JAX); ``profile_steps`` (the Manager's and the autoencoder's
    first dispatches traced by torch.profiler) and ``tensorboard`` (every
    trainer's scalars mirrored as TensorBoard events)."""

    image_dir: str = _default("full_data_set/images/")
    text_data_dir: str = _default("training_data/text/")
    bert_pretrained_dir: str = _default("bert_pretrain_all_notes_150000")
    bert_config_name: str = "bert_config.json"
    save_directory: str = _default("save_dir")
    dataset_metadata: str = _default("training_data/training_label_negbio.csv")
    dataset_disease_stats: str = _default("training_data/disease_stats.csv")

    batch_size: int = 64
    data_loader_workers: int = 32
    num_train_epochs: int = 20
    num_train_epochs_classifier: int = 100
    mi_estimator: str = "dv"   # 'dv' | 'infonce' | 'infonce_per_anchor'
    init_lr: float = 1e-4
    max_seq_length: int = 320
    img_size: int = 256
    output_channels: int = 1
    image_model_name: str = "resnet256_6_2_1"
    disease_label: str = "Pneumonia"
    optimizer: str = "Adam"       # the classifier's: 'Adam' | 'SGD'

    seed: int = 0
    compute_dtype: str = "bfloat16"
    global_negatives: bool = True
    mesh_shape: tuple = ()
    dcn_mesh_shape: tuple = ()
    bert_lr: float = 2e-5
    warmup_fraction: float = 0.1
    use_pallas_critic: bool = True
    flash_attention: bool = True
    freeze_image_encoder: bool = False
    freeze_text_encoder: bool = False
    s2d_stem: bool = False
    u8_dropout: bool = False
    gelu_tanh: bool = False
    adamw_moment_dtype: str = "float32"
    adam_moment_dtype: str = "float32"
    fused_ffn: bool = False
    pallas_stem: bool = False
    compact_transfer: bool = True
    decoded_crop_cache: str = ""
    rng_impl: str = "unsafe_rbg"
    seq_buckets: tuple = ()
    scan_steps: int = 1
    grad_cache_chunks: int = 1
    sequence_parallel: bool = False
    pipeline_microbatches: int = 0
    zero1_optimizer_sharding: bool = False
    fsdp_parameter_sharding: bool = False
    grad_allreduce_dtype: str = "float32"
    prefetch: int = 2
    checkpoint_every_epochs: int = 1
    profile_steps: int = 0
    tensorboard: bool = False
    resume_from: str = ""
    keep_checkpoints: int = 0
    checkpoint_format: str = "pickle"

    def replace(self, **kw) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def production(cls, **overrides) -> "TrainingConfig":
        """The production configuration (what the JAX bench measures)."""
        return cls(**{**_PRODUCTION_OVERRIDES, **overrides})

    @classmethod
    def parity(cls, **overrides) -> "TrainingConfig":
        """Reference-parity numerics: exact erf GELU, f32 compute and
        moments, every report padded to max_seq_length."""
        return cls(**{**_PARITY_OVERRIDES, **overrides})


# mimm_tpu/config.py:350-373, verbatim
_PRODUCTION_OVERRIDES = dict(
    compute_dtype="bfloat16",
    gelu_tanh=True,                 # <=1e-3 abs GELU deviation, disclosed
    u8_dropout=True,                # 1/256 keep-prob resolution, disclosed
    adamw_moment_dtype="bfloat16",  # update math stays f32
    adam_moment_dtype="bfloat16",
    seq_buckets=PRODUCTION_SEQ_BUCKETS,
    scan_steps=8,                   # multi-step dispatch (neutral >=8)
    use_pallas_critic=True,
    flash_attention=True,           # engages at L >= flash_min_seq_len
    compact_transfer=True,
    rng_impl="unsafe_rbg",          # TPU hardware PRNG for dropout masks
)
_PARITY_OVERRIDES = dict(
    compute_dtype="float32",
    gelu_tanh=False,                # exact erf GELU
    adamw_moment_dtype="float32",
    adam_moment_dtype="float32",
    seq_buckets=(),                 # reference: pad everything to 320
    scan_steps=1,
    use_pallas_critic=False,
    flash_attention=False,
    compact_transfer=False,
    rng_impl="threefry2x32",
)


def _parse_mesh_shape(s: str) -> tuple:
    """``data=4,model=2`` -> (("data", 4), ("model", 2))."""
    if not s.strip():
        return ()
    pairs = []
    for part in s.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if not name or not size.strip().isdigit() or int(size) < 1:
            raise argparse.ArgumentTypeError(
                f"--mesh_shape expects axis=size pairs with size >= 1, "
                f"e.g. 'data=4,model=2'; got {part!r}")
        if any(n == name for n, _ in pairs):
            raise argparse.ArgumentTypeError(
                f"--mesh_shape axis {name!r} given twice")
        pairs.append((name, int(size)))
    return tuple(pairs)


def _add_fields(parser: argparse.ArgumentParser, cfg) -> None:
    """One flag per field.  default=SUPPRESS: the namespace holds only the
    flags given, so they override a --preset and the rest keeps its
    values (help shows the dataclass default)."""
    for f in dataclasses.fields(cfg):
        default = getattr(cfg, f.name)
        help_ = f"(default: {default!r})"
        if f.name in ("mesh_shape", "dcn_mesh_shape"):
            arg_type = _parse_mesh_shape
        elif type(default) is bool:
            arg_type = lambda s: s.lower() in ("1", "true", "yes")
        elif type(default) is tuple:
            # comma-separated ints, e.g. --seq_buckets 64,128,192,320
            arg_type = lambda s: tuple(int(x) for x in s.split(",")
                                       if x.strip())
        else:
            arg_type = type(default)
        parser.add_argument(f"--{f.name}", type=arg_type,
                            default=argparse.SUPPRESS, help=help_)


def construct_training_parameters(
        argv: Optional[Sequence[str]] = None,
        parents: Sequence[argparse.ArgumentParser] = ()) -> TrainingConfig:
    """The reference's flags (helpers.py:84-144) and ``--preset
    {production,parity}``: the named preset, then every flag given on
    top.  ``parents``: parsers (``add_help=False``) of an entry point's
    own flags, shown in the help and left out of the config."""
    parser = argparse.ArgumentParser(parents=list(parents))
    parser.add_argument("--preset", choices=("production", "parity"),
                        default="",
                        help="named base config (TrainingConfig.production/"
                             ".parity); explicit flags override it")
    _add_fields(parser, TrainingConfig())
    ns = vars(parser.parse_args(argv))
    for p in parents:
        for dest in vars(p.parse_known_args([])[0]):
            ns.pop(dest, None)
    preset = ns.pop("preset", "")
    base = {"production": TrainingConfig.production,
            "parity": TrainingConfig.parity}.get(preset, TrainingConfig)()
    return base.replace(**ns)


def construct_dataset_parameters(argv: Optional[Sequence[str]] = None
                                 ) -> DatasetConfig:
    """The reference's dataset flags (helpers.py:7-82): one per field of
    ``DatasetConfig``, each overriding its default."""
    parser = argparse.ArgumentParser()
    _add_fields(parser, DatasetConfig())
    return dataclasses.replace(DatasetConfig(),
                               **vars(parser.parse_args(argv)))
