"""Typed config — JSON defaults + CLI/dict overrides.

A copy of ``zsgnet_tpu/config.py``'s ``Config``, ``get_default_cfg`` and
``update_from_dict`` with the same fields and defaults, so every
``cfg.json`` written for the JAX package loads here unchanged. Fields that
select TPU-only machinery (``use_pallas``, ``use_level_path``, meshes,
spatial partitioning) are kept for that compatibility; this package reads
the model, loss, evaluation and serving-format (``head_canvas``,
``quant_mode``, ``quant_head``) fields and ignores the rest.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

# 2^(1/3), 2^(2/3): RetinaNet octave scales, matching the reference cfg.json.
_DEFAULT_SCALES = (1.0, 1.2599210498948732, 1.5874010519681994)
_DEFAULT_RATIOS = (0.5, 1.0, 2.0)


@dataclasses.dataclass(frozen=True)
class Config:
    # --- experiment / dataset (reference keys) ---
    uid: str = "zsg_tpu"
    ds_to_use: str = "refclef"
    mdl_to_use: str = "retina"  # retina (ResNet50+FPN) | ssd_vgg
    data_dir: str = "data"
    test_split: str = "test"
    bs: int = 16
    nw: int = 4
    epochs: int = 10
    lr: float = 1e-4
    resize_img: tuple[int, int] = (300, 300)
    # --- query encoder ---
    emb_dim: int = 300
    glove_path: str = ""
    vocab_splits: str = "train"  # train | all
    lstm_dim: int = 256          # per-direction hidden; BiLSTM output = 512
    max_qlen: int = 50
    vocab_size: int = 0          # 0 = derive from dataset vocab at build time
    # --- anchors / head ---
    ratios: tuple[float, ...] = _DEFAULT_RATIOS
    scales: tuple[float, ...] = _DEFAULT_SCALES
    matching_threshold: float = 0.5
    neg_threshold: float = 0.4
    acc_iou_threshold: float = 0.5
    use_same_atb: bool = True
    fpn_ch: int = 256
    head_ch: int = 256
    ssd_uniform_proj: bool = False
    # --- loss (reference variants) ---
    lamb_reg: float = 1.0
    use_focal: bool = True
    use_softmax: bool = False
    use_multi: bool = True
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # --- training runtime ---
    opt_to_use: str = "adam"
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    grad_accum: int = 1
    queries_per_img: int = 1
    grouped_reseed: bool = True
    ema_decay: float = 0.0
    use_reduce_lr_plateau: bool = False
    plateau_factor: float = 0.1
    plateau_patience: int = 2
    lr_schedule: str = "const"  # const | cosine | linear
    warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_min_frac: float = 0.0
    seed: int = 0
    resume: bool = False
    resume_path: str = ""
    load_normally: bool = True
    only_val: bool = False
    only_test: bool = False
    log_every: int = 20
    ckpt_every_epochs: int = 1
    ckpt_every_steps: int = 0
    tmp_path: str = "tmp"
    # --- numerics and the JAX package's device knobs ---
    # "bfloat16" runs the convolutions under torch.autocast on CUDA; the
    # query encoder, the loss and the decode stay float32.
    compute_dtype: str = "bfloat16"
    use_pallas: bool = True
    use_level_path: bool = True
    normalize_on_device: bool = True
    use_packed_cache: bool = False
    do_dist: bool = True
    mesh_shape: tuple[int, ...] = (-1,)
    data_axis: str = "data"
    mesh_spatial: int = 1
    spatial_axis: str = "spatial"
    spatial_mode: str = "auto"
    prefetch_depth: int = 2
    remat_backbone: bool = False
    tpu_vmem_kib: int = 24576
    head_canvas: bool = False
    spd_stem: bool = False
    use_tensorboard: bool = False
    bn_variance: str = "exact"
    quant_mode: str = "off"
    quant_head: bool = True
    bn_sync_axis: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        _enums = {
            "lr_schedule": ("const", "cosine", "linear"),
            "spatial_mode": ("auto", "halo", "gspmd"),
            "vocab_splits": ("train", "all"),
            "mdl_to_use": ("retina", "ssd_vgg"),
            "bn_variance": ("exact", "fast", "shifted", "shifted16"),
        }
        for key, allowed in _enums.items():
            if getattr(self, key) not in allowed:
                raise ValueError(
                    f"{key}={getattr(self, key)!r} must be one of {allowed}"
                )
        for key in ("grad_accum", "queries_per_img", "mesh_spatial"):
            if int(getattr(self, key)) < 1:
                raise ValueError(f"{key} must be >= 1, got {getattr(self, key)}")

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)

    @property
    def lang_dim(self) -> int:
        return 2 * self.lstm_dim

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **_coerce(self, kw))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=list)


# Aliases so reference-style CLI flags keep working.
KEY_MAPS = {
    "batch_size": "bs",
    "num_workers": "nw",
    "num_epochs": "epochs",
    "match_thr": "matching_threshold",
    "neg_thr": "neg_threshold",
}


def _coerce(cfg: Config, overrides: dict[str, Any]) -> dict[str, Any]:
    """Map aliases and coerce CLI string values to the field's type."""
    fields = {f.name: f for f in dataclasses.fields(Config)}
    out: dict[str, Any] = {}
    for key, val in overrides.items():
        key = KEY_MAPS.get(key, key)
        if key not in fields:
            raise KeyError(f"unknown config key: {key!r}")
        cur = getattr(cfg, key)
        if isinstance(val, str):
            if isinstance(cur, bool):
                val = val.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                val = int(val)
            elif isinstance(cur, float):
                val = float(val)
            elif isinstance(cur, tuple):
                val = tuple(json.loads(val))
        elif isinstance(val, list):
            val = tuple(val)
        out[key] = val
    return out


def get_default_cfg(config_path: str | Path | None = None) -> Config:
    """Defaults, optionally overlaid with a JSON file (configs/cfg.json)."""
    cfg = Config()
    if config_path is None:
        default = Path(__file__).resolve().parent.parent / "configs" / "cfg.json"
        config_path = default if default.exists() else None
    if config_path is not None:
        with open(config_path) as f:
            # Keys starting with "_" document preset files; not config fields.
            loaded = {k: v for k, v in json.load(f).items() if not k.startswith("_")}
        cfg = cfg.replace(**loaded)
    return cfg


def update_from_dict(cfg: Config, overrides: dict[str, Any]) -> Config:
    """Reference-API-compatible override merge (aliases + type coercion)."""
    return cfg.replace(**overrides)
