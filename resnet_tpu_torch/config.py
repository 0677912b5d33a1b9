"""Configuration for the PyTorch port, field for field with resnet_tpu.config.

``ModelConfig``, ``tiny_model_config``, ``PRESETS``, ``model_config``,
``OptimizerConfig``, ``DataConfig``, ``ParallelConfig``, ``TrainConfig``,
``RESUME_LATEST``, ``VARIANT_PRESETS`` and ``variant_config`` are copies of
the JAX package's. ``ExecutionConfig`` drops the TPU-only fields
(``pallas_interpret``, ``scoped_vmem_limit_kib``, ``grad_accum_unroll`` and
``jit_compiler_options``). Values the port cannot run yet raise
``NotImplementedError`` naming the ROADMAP.md queue A item that brings them.

The ``'pallas'`` engine names keep their meaning: the hand-written kernels
(on the card, the CUDA kernels of ``resnet_tpu_torch/kernels``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name):
    """Map a dtype name (or dtype) to a torch dtype."""
    if isinstance(name, str):
        return _DTYPES[name]
    return name


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a configuration the port does not run yet."""
    return NotImplementedError(
        f"{what} is not ported to resnet_tpu_torch yet "
        f"(ROADMAP.md queue A, {item})"
    )


ROADMAP_BF16 = "item A5: bf16 compute"
ROADMAP_NCHW = "item A6: NCHW layout"
ROADMAP_GROUPED = "item A7: grouped conv kernel"
ROADMAP_S2D = "item A8: space-to-depth stem"
ROADMAP_DATA = "item A11: data"
ROADMAP_PARALLEL = "item A13: parallelism"


@dataclass(frozen=True)
class ModelConfig:
    """ResNet model hyper-shape; defaults are the reference ResNet-50
    (resnet.cu:3245-3258). See resnet_tpu.config.ModelConfig."""

    name: str = "resnet50"
    input_dim: int = 224
    in_channels: int = 3
    num_classes: int = 1000

    init_kernel: int = 7
    init_filters: int = 64
    init_stride: int = 2
    maxpool_kernel: int = 3
    maxpool_stride: int = 2

    block_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    bottleneck: bool = True
    expansion: int = 4
    width_multiplier: float = 1.0
    groups: int = 1

    # Reference quirk: 3x3/s2 projections at stage transitions
    # (resnet.cu:770-797); 1 gives the standard topology.
    stride_projection_kernel: int = 3

    zero_init_residual: bool = False
    fc_bias: bool = False

    bn_eps: float = 1e-7
    bn_momentum: float = 0.9
    track_running_stats: bool = True

    @property
    def num_blocks(self) -> int:
        return sum(self.block_sizes)

    @property
    def final_depth(self) -> int:
        base = self.init_filters * (2 ** (len(self.block_sizes) - 1))
        return base * self.expansion if self.bottleneck else base

    def stage_of_block(self, block_idx: int) -> int:
        acc = 0
        for stage, n in enumerate(self.block_sizes):
            acc += n
            if block_idx < acc:
                return stage
        raise ValueError(f"block {block_idx} out of range")

    def is_reduction_block(self, block_idx: int) -> bool:
        """True when this block halves spatial dims (stride-2 3x3)."""
        starts = [sum(self.block_sizes[:i]) for i in range(len(self.block_sizes))]
        return block_idx in starts[1:]

    def is_projection_block(self, block_idx: int) -> bool:
        """True when this block carries a projection shortcut."""
        starts = [sum(self.block_sizes[:i]) for i in range(len(self.block_sizes))]
        return block_idx in starts


@dataclass(frozen=True)
class ExecutionConfig:
    """How the model executes; see resnet_tpu.config.ExecutionConfig."""

    # 'xla' (plain torch ops) | 'pallas' (hand kernels) | the fused engines
    # 'fused' (hand kernels), 'hybrid', 'fusedxla' (torch ops), which run
    # the training forward only (models/fused_resnet.py) | 'blockfused' (the
    # whole-block kernel for the stride-1 identity blocks of a training
    # forward, plain ops elsewhere; models/resnet.py)
    kernels: str = "xla"
    conv_kernels: str = "xla"  # 'xla' | 'pallas'
    layout: str = "NHWC"
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    remat: str = "none"
    stable_softmax: bool = True
    # the plain convs and matmuls on the card: 'highest' turns the cuDNN
    # and cuBLAS TF32 flags off for the length of each entry point, 'high'
    # and 'default' allow TF32 (ops/precision.py; the hand kernels are fp32
    # accurate either way)
    matmul_precision: str = "highest"
    space_to_depth: bool = False
    relu_cap: Optional[float] = None
    bn_mode: str = "batch"
    bn_stats_batch: int = 0
    maxpool_vjp: str = "select_scatter"
    grad_accum: int = 1

    def __post_init__(self):
        _check = {
            "kernels": (self.kernels,
                        ("xla", "pallas", "fused", "hybrid", "fusedxla",
                         "blockfused")),
            "conv_kernels": (self.conv_kernels, ("xla", "pallas")),
            "layout": (self.layout, ("NHWC", "NCHW")),
            "compute_dtype": (self.compute_dtype, ("float32", "bfloat16")),
            "param_dtype": (self.param_dtype, ("float32", "bfloat16")),
            "remat": (self.remat, ("none", "block", "stage", "elementwise")),
            "bn_mode": (self.bn_mode, ("batch", "frozen", "off")),
            "matmul_precision": (self.matmul_precision,
                                 ("default", "high", "highest")),
            "maxpool_vjp": (self.maxpool_vjp, ("select_scatter", "mask")),
        }
        for field, (value, allowed) in _check.items():
            if value not in allowed:
                raise ValueError(
                    f"ExecutionConfig.{field}={value!r}; expected one of "
                    f"{allowed}"
                )
        if self.bn_stats_batch < 0:
            raise ValueError(
                f"ExecutionConfig.bn_stats_batch={self.bn_stats_batch}; "
                "expected 0 (full batch) or a positive stats-sample size"
            )
        if self.grad_accum < 1:
            raise ValueError(
                f"ExecutionConfig.grad_accum={self.grad_accum}; expected"
                " a positive microbatch count"
            )
        if self.layout == "NCHW":
            raise not_ported("ExecutionConfig.layout='NCHW'", ROADMAP_NCHW)
        if self.compute_dtype != "float32" or self.param_dtype != "float32":
            raise not_ported("bfloat16 compute or parameters", ROADMAP_BF16)
        if self.space_to_depth:
            raise not_ported("ExecutionConfig.space_to_depth", ROADMAP_S2D)

    @property
    def cdtype(self):
        return resolve_dtype(self.compute_dtype)

    @property
    def pdtype(self):
        return resolve_dtype(self.param_dtype)


def tiny_model_config(**overrides) -> ModelConfig:
    """A small ResNet for CPU tests: 16x16 input, 4 blocks, 8 classes."""
    base = dict(
        name="resnet-tiny",
        input_dim=16,
        num_classes=8,
        init_kernel=3,
        init_filters=8,
        init_stride=2,
        maxpool_kernel=3,
        maxpool_stride=2,
        block_sizes=(1, 1),
        expansion=4,
    )
    base.update(overrides)
    return ModelConfig(**base)


PRESETS = {
    "resnet18": dict(block_sizes=(2, 2, 2, 2), bottleneck=False, expansion=1),
    "resnet34": dict(block_sizes=(3, 4, 6, 3), bottleneck=False, expansion=1),
    "resnet50": dict(block_sizes=(3, 4, 6, 3), bottleneck=True, expansion=4),
    "resnet101": dict(block_sizes=(3, 4, 23, 3), bottleneck=True, expansion=4),
    "resnet152": dict(block_sizes=(3, 8, 36, 3), bottleneck=True, expansion=4),
    "wide_resnet50_2": dict(
        block_sizes=(3, 4, 6, 3), bottleneck=True, expansion=4,
        width_multiplier=2.0,
    ),
    "wide_resnet101_2": dict(
        block_sizes=(3, 4, 23, 3), bottleneck=True, expansion=4,
        width_multiplier=2.0,
    ),
    "resnext50_32x4d": dict(
        block_sizes=(3, 4, 6, 3), bottleneck=True, expansion=4,
        width_multiplier=2.0, groups=32,
    ),
    "resnext101_32x8d": dict(
        block_sizes=(3, 4, 23, 3), bottleneck=True, expansion=4,
        width_multiplier=4.0, groups=32,
    ),
}


@dataclass(frozen=True)
class OptimizerConfig:
    """Trainer hyperparameters; see resnet_tpu.config.OptimizerConfig."""

    name: str = "adam"  # 'adam' | 'sgd'
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7
    momentum: float = 0.9  # for sgd
    # 'no_bn' exempts BN gamma/beta and biases from weight decay
    wd_mask: str = "all"  # 'all' | 'no_bn'
    # per-element non-finite guards of the reference optimizer kernels
    nonfinite_guard: bool = True
    schedule: str = "constant"  # 'constant' | 'cosine' | 'step'
    warmup_steps: int = 0
    total_steps: int = 0  # required for cosine and step
    # the fused Adam kernel (resnet_tpu_torch.kernels.adam)
    fused: bool = False
    label_smoothing: float = 0.0


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline configuration; see resnet_tpu.config.DataConfig."""

    shard_dir: str = ""
    shard_images: int = 32768
    batch_size: int = 32
    layout: str = "NHWC"
    num_shards: int = 40
    prefetch: int = 2
    transfer_dtype: str = "float32"  # 'float32' | 'bfloat16'
    synthetic: bool = False
    device_batches: int = 0
    jpeg_dir: str = ""
    random_flip: bool = False
    channel_means: Tuple[float, float, float] = (123.68, 116.78, 103.94)


@dataclass(frozen=True)
class ParallelConfig:
    """Device mesh configuration; see resnet_tpu.config.ParallelConfig. Only
    the default (one device) runs in the port so far."""

    data_axis: str = "data"
    num_devices: int = 0
    mode: str = "auto"
    spatial_devices: int = 1
    spatial_axis: str = "spatial"
    zero_sharding: bool = False
    zero_min_bytes: int = 2 ** 16


# TrainConfig.resume_from sentinel: resume from the newest complete dump
RESUME_LATEST = -2


@dataclass(frozen=True)
class TrainConfig:
    """See resnet_tpu.config.TrainConfig. Raises for what the port's
    training step does not run yet: any parallel layout."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    execution: ExecutionConfig = dataclasses.field(default_factory=ExecutionConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    seed: int = 1234
    epochs: int = 40
    checkpoint_every: int = 1000
    checkpoint_dir: str = "training_dumps/my_custom"
    log_every: int = 1
    resume_from: int = -1
    async_checkpoint: bool = False
    record_metrics: bool = True
    check_errors: bool = False

    def __post_init__(self):
        if self.parallel != ParallelConfig():
            raise not_ported("a non-default ParallelConfig", ROADMAP_PARALLEL)


# The reference's six binaries as config presets (resnet_tpu.config)
VARIANT_PRESETS = {
    "resnet": dict(
        execution=dict(kernels="pallas", remat="none"),
        optimizer=dict(learning_rate=1e-4),
        data=dict(batch_size=32),
    ),
    "clean": dict(
        execution=dict(kernels="pallas", remat="block"),
        optimizer=dict(learning_rate=1e-4),
        data=dict(batch_size=224),
    ),
    "cudnn": dict(
        execution=dict(kernels="xla", layout="NHWC"),
        optimizer=dict(learning_rate=1e-3),
        data=dict(batch_size=64),
    ),
    "lowmem": dict(
        execution=dict(kernels="xla", remat="block"),
        optimizer=dict(learning_rate=1e-3),
        data=dict(batch_size=192),
    ),
    "nchw": dict(
        execution=dict(kernels="xla", layout="NCHW"),
        optimizer=dict(learning_rate=1e-3),
        data=dict(batch_size=192, layout="NCHW"),
    ),
    "fast": dict(
        execution=dict(
            kernels="xla", compute_dtype="bfloat16",
            matmul_precision="default", relu_cap=10.0,
        ),
        optimizer=dict(learning_rate=1e-3),
        data=dict(batch_size=192),
    ),
}


def variant_config(variant: str, model: str = "resnet50", **overrides) -> TrainConfig:
    """A TrainConfig reproducing one of the reference's six trainer
    variants; overrides update top-level TrainConfig fields."""
    if variant not in VARIANT_PRESETS:
        raise ValueError(f"unknown variant {variant!r}; have {sorted(VARIANT_PRESETS)}")
    p = VARIANT_PRESETS[variant]
    cfg = TrainConfig(
        model=model_config(model),
        execution=ExecutionConfig(**p.get("execution", {})),
        optimizer=OptimizerConfig(**p.get("optimizer", {})),
        data=DataConfig(**p.get("data", {})),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def model_config(name: str = "resnet50", **overrides) -> ModelConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown model {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return ModelConfig(name=name, **kw)
