"""Configuration the port shares with the JAX package (copied, not
imported): the classifier architecture, ``TrainingConfig`` with the fields
the MI train step reads, the ``production()`` / ``parity()`` presets
(mimm_tpu/config.py:79-373) and ``PRODUCTION_SEQ_BUCKETS``.  The other
fields of the JAX config come with the slices that read them."""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

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
class TrainingConfig:
    """Training flags (reference helpers.py:84-144) and the JAX package's
    knobs that the MI step reads, with the JAX defaults.

    The port runs: ``compute_dtype``, ``mi_estimator``, ``use_pallas_critic``
    (the critic's size switch), ``flash_attention``, ``gelu_tanh``,
    ``u8_dropout``, both moment dtypes, the freezes, and
    ``global_negatives`` on one device.  TPU schedules it accepts because
    they give the same result: ``scan_steps`` (K steps run as a loop),
    ``rng_impl`` (masks come from torch generators), ``compact_transfer``.
    Knobs of later slices raise in ``train/mi.py`` when set: ``s2d_stem``,
    ``pallas_stem``, ``fused_ffn``, ``grad_cache_chunks`` > 1, the mesh
    and parallel modes."""

    bert_pretrained_dir: str = _default("bert_pretrain_all_notes_150000")
    bert_config_name: str = "bert_config.json"
    save_directory: str = _default("save_dir")

    batch_size: int = 64
    num_train_epochs: int = 20
    mi_estimator: str = "dv"   # 'dv' | 'infonce' | 'infonce_per_anchor'
    init_lr: float = 1e-4
    max_seq_length: int = 320
    img_size: int = 256
    output_channels: int = 1
    image_model_name: str = "resnet256_6_2_1"

    seed: int = 0
    compute_dtype: str = "bfloat16"
    global_negatives: bool = True
    mesh_shape: tuple = ()
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
    rng_impl: str = "unsafe_rbg"
    seq_buckets: tuple = ()
    scan_steps: int = 1
    grad_cache_chunks: int = 1
    sequence_parallel: bool = False
    pipeline_microbatches: int = 0
    zero1_optimizer_sharding: bool = False
    fsdp_parameter_sharding: bool = False
    grad_allreduce_dtype: str = "float32"

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
