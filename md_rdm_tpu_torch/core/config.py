"""Configuration of the PyTorch port.

Copies of the JAX package's ``ModelConfig``, ``SIDConfig``, ``DataConfig``,
``TrainConfig`` and ``Config`` with the same field names and defaults, so
that the ``config.json`` a training run writes loads in both packages
(:meth:`Config.from_dict`, :meth:`ModelConfig.from_dict`).  The port keeps
its own copy because it must not import the JAX package.

``fused_dense`` ("auto", "on", "on_all", "on_all_bwd", "off",
"interpret") routes the dense layers through the hand-written sandwich
kernels, ``flat_block`` ("auto", "on", "on_all", "off", "interpret")
runs a routed dense block as one in-place buffer, and ``growth_matmul``
("auto", "on", "on_all", "off") runs the 3x3 growth convs as one matmul:
``models/routing.py`` says what each value does.  The relative decoders
of size >= 16 run the fused comparison + quantization kernel
(``kernels/lloyd.py``) on CUDA.
``remat`` (default True, as in the JAX package) runs each layer of the
three encoder blocks under ``torch.utils.checkpoint``: it keeps only its
input and runs again in the backward (a routed layer without its
forward kernels); the decoder's block is not rematerialized, as in JAX.
``pallas_lloyd`` is kept for the config's compatibility; the port does
not read it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

# Decoder output resolution by id: ids 1-5 are DORN ordinal decoders at
# 8..128 px, ids 6-10 relative (comparison + ALS) decoders at 8..128 px.
DECODER_SIZES = {1: 8, 2: 16, 3: 32, 4: 64, 5: 128,
                 6: 8, 7: 16, 8: 32, 9: 64, 10: 128}

# Fine-detail slot sizes: slot i holds maps of spatial size 2**i.
SLOT_SIZES = tuple(2 ** i for i in range(8))


def decomposition_depth(decoder_id: int) -> int:
    """Decomposition depth n = log2(output size) of a decoder's map."""
    return {8: 3, 16: 4, 32: 5, 64: 6, 128: 7}[DECODER_SIZES[decoder_id]]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture configuration for ``DepthEstimationNet``."""

    decoder_ids: Tuple[int, ...] = (1,)
    image_size: int = 226
    ordinal_channels: int = 180
    freeze_encoder: bool = False
    # "bfloat16" or "float32" for the conv backbone; the fusion tail is
    # always float32.
    compute_dtype: str = "float32"
    remat: bool = True
    soft_ordinal_decode: bool = False
    als_iters_quadratic: int = 30
    als_iters_rect: int = 100
    pallas_lloyd: str = "auto"
    fused_dense: str = "auto"
    flat_block: str = "auto"
    growth_matmul: str = "auto"
    # Fusion-weight initialization: "abs_randn" (|N(0,1)|, the reference),
    # "normalized" (each slot sums to 1) or "primary" (first candidate 1,
    # the rest 0.01).
    fusion_init: str = "abs_randn"
    # Fusion-tail stabilization floor; 0.0 is the faithful reference tail.
    fusion_eps: float = 0.0

    def __post_init__(self):
        for d in self.decoder_ids:
            if d not in DECODER_SIZES:
                raise ValueError(f"unknown decoder id {d}")
        if len(set(self.decoder_ids)) != len(self.decoder_ids):
            raise ValueError("duplicate decoder ids")
        if self.fusion_init not in ("abs_randn", "normalized", "primary"):
            raise ValueError(f"unknown fusion_init {self.fusion_init!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ModelConfig":
        """Build from the ``model`` section of a run's ``config.json``
        (JSON turns the decoder tuple into a list)."""
        d = dict(d)
        if "decoder_ids" in d:
            d["decoder_ids"] = tuple(d["decoder_ids"])
        return cls(**d)

    @property
    def dorn_ids(self) -> Tuple[int, ...]:
        return tuple(d for d in self.decoder_ids if d <= 5)

    @property
    def relative_ids(self) -> Tuple[int, ...]:
        return tuple(d for d in self.decoder_ids if d > 5)

    @property
    def has_ordinal(self) -> bool:
        return bool(self.dorn_ids)

    @property
    def vector_sizes(self) -> Tuple[int, ...]:
        """Fusion weight-vector length per slot.  A DORN decoder with a map
        of size 2**n yields slots 0..n, a relative decoder slots 1..n; the
        live config (1,) gives (1,1,1,1,0,0,0,0)."""
        sizes = [0] * 8
        for d in self.decoder_ids:
            n = decomposition_depth(d)
            lo = 0 if d <= 5 else 1
            for slot in range(lo, n + 1):
                sizes[slot] += 1
        return tuple(sizes)

    @property
    def active_slots(self) -> Tuple[int, ...]:
        """Slots with at least one candidate, ascending."""
        return tuple(i for i, s in enumerate(self.vector_sizes) if s > 0)


@dataclasses.dataclass(frozen=True)
class SIDConfig:
    """Spacing-increasing discretization constants: label = K *
    ln(depth / alpha) / ln(beta / alpha).  The training path uses K=90 for
    NYU; the reference's K=68 table is ``training_path=False``."""

    alpha: float = 0.02
    beta: float = 10.0
    K: float = 90.0

    @staticmethod
    def for_dataset(name: str, training_path: bool = True) -> "SIDConfig":
        table = {
            "kitti": SIDConfig(0.001, 80.0, 71.0),
            "nyu": SIDConfig(0.02, 10.0, 90.0 if training_path else 68.0),
            "floorplan3d": SIDConfig(0.0552, 10.0, 68.0),
            "structured3d": SIDConfig(0.02, 10.0, 68.0),
        }
        key = name.lower()
        if key not in table:
            raise ValueError(f"no dataset named {name}")
        return table[key]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data settings.  The loop reads ``batch_size`` and
    ``augment_backend`` ("device": raw train batches augmented in the
    train step, ``data/augment.py``); ``cli/train.py`` builds the datasets
    (``data/{nyu,kitti,floorplan3d,structured3d,synthetic}.py``) from its
    own flags, as the JAX CLI does, and records them here."""

    dataset: str = "nyu"
    dataset_type: str = "sparse_2_dense"
    path: Optional[str] = None
    output_size: Tuple[int, int] = (226, 226)
    resize: int = 250
    batch_size: int = 4
    eval_batch_size: int = 1
    num_workers: int = 6
    augment_backend: str = "host"
    n_images: int = -1
    download: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule, metric and run settings.  ``fast_modules``
    lists top-level submodules (``encoder``, ``d_1``, ``weight_layer``)
    trained at ``fast_lr_multiplier`` x the base learning rate.
    ``metrics_space`` "faithful" scores the log-space recombined map as the
    reference does; "linear" exponentiates it first."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    min_epochs: int = 1
    max_epochs: int = 1
    seed: Optional[int] = None
    fast_modules: Tuple[str, ...] = ()
    fast_lr_multiplier: float = 10.0
    plateau_patience: int = 2
    plateau_factor: float = 0.1
    monitor: str = "delta1"
    metrics: Tuple[str, ...] = (
        "delta1", "delta2", "delta3", "mse", "mae", "log10", "rmse")
    metrics_space: str = "faithful"
    overfit: bool = False
    dev: bool = False
    debug_nans: bool = False
    log_every: int = 10
    checkpoint_dir: str = "result"
    run_name: str = "rd"
    run_dirs: bool = True
    save_top_k: int = 1
    resume: Optional[str] = None
    data_parallel: int = -1


def _tuples(cls, d: Mapping[str, Any]):
    """``cls(**d)`` with the lists JSON made of tuple fields turned back
    into tuples."""
    d = dict(d)
    for f in dataclasses.fields(cls):
        if isinstance(d.get(f.name), list):
            d[f.name] = tuple(d[f.name])
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    sid: SIDConfig = dataclasses.field(default_factory=SIDConfig)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        """Build from the ``config`` section of a run's ``config.json``
        (``dataclasses.asdict`` of either package's ``Config``)."""
        return cls(model=ModelConfig.from_dict(d.get("model", {})),
                   data=_tuples(DataConfig, d.get("data", {})),
                   train=_tuples(TrainConfig, d.get("train", {})),
                   sid=SIDConfig(**d.get("sid", {})))
