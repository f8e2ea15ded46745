"""The config tree and YAML presets, the port's own copy.

Same schema, keys and defaults as ``mickey_tpu/config.py`` (a dict with
attribute access and yacs-style merging, mirroring the reference
``config/default.py``), so the YAML presets and the ``config.yaml`` of
released weight archives load unchanged. Kept here so that the port imports
nothing of the JAX package; ``tests/test_torch_model.py`` holds the two
``default_config()`` trees equal.
"""

from __future__ import annotations

import copy
import io
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

PRESETS = Path(__file__).parent / "configs"


class Config(dict):
    """Nested dict with attribute access and yacs-style merging."""

    _FROZEN_KEY = "__frozen__"

    def __init__(self, d: Optional[Dict[str, Any]] = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if d:
            for k, v in d.items():
                self[k] = Config(v) if isinstance(v, dict) else v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {name!r}")
        self[name] = Config(value) if isinstance(value, dict) and not isinstance(value, Config) else value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {key!r}")
        super().__setitem__(key, value)

    # -- merging -------------------------------------------------------------
    def merge_from_other(self, other: Dict[str, Any], _path: str = "") -> None:
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], Config):
                    self[k] = Config()
                self[k].merge_from_other(v, full)
            else:
                # Reference YAMLs use the literal string 'None' in places
                # (e.g. ``SCENES: None`` in config/datasets/mapfree.yaml).
                if isinstance(v, str) and v == "None":
                    v = None
                self[k] = v

    def merge_from_file(self, path: str) -> None:
        with open(path, "r") as f:
            data = yaml.safe_load(f)
        if data:
            self.merge_from_other(data)

    def merge_from_yaml(self, text: str) -> None:
        data = yaml.safe_load(io.StringIO(text))
        if data:
            self.merge_from_other(data)

    def merge_from_list(self, opts) -> None:
        """Merge from a flat ``[key, value, key, value, ...]`` list.

        Keys use dotted paths, e.g. ``PROCRUSTES.IT_RANSAC 50``.
        """
        assert len(opts) % 2 == 0, "override list must have even length"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if isinstance(value, str):
                value = yaml.safe_load(value)
            node[parts[-1]] = value

    # -- lifecycle -----------------------------------------------------------
    def __reduce__(self):
        """Pickled as its plain dict (data-parallel ranks receive configs)."""
        return _unpickle, (self.to_dict(), object.__getattribute__(self, "_frozen"))

    def clone(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def freeze(self) -> "Config":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, Config):
                v.freeze()
        return self

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _unpickle(d: Dict[str, Any], frozen: bool) -> Config:
    cfg = Config(d)
    return cfg.freeze() if frozen else cfg


def default_config() -> Config:
    """Full schema with defaults.

    Mirrors reference ``config/default.py`` (fields there default to ``None``
    and are populated by YAML overlays; here we bake in the values of the
    released ``curriculum_learning.yaml`` + ``datasets/mapfree.yaml`` presets
    so a bare ``default_config()`` builds the flagship model).
    """
    return Config(
        {
            "MODEL": "MicKey",
            "DEBUG": False,
            "MICKEY": {
                "DINOV2": {
                    "VARIANT": "vit_large",
                    "DOWN_FACTOR": 14,
                    "CHANNEL_DIM": 1024,
                    "FLOAT16": True,
                    "INT8": False,
                },
                "KP_HEADS": {
                    "BLOCKS_DIM": [512, 256, 128, 64],
                    "BN": True,
                    "USE_SOFTMAX": True,
                    "USE_DEPTHSIGMOID": False,
                    "MAX_DEPTH": 60,
                    "POS_ENCODING": True,
                },
                "DSC_HEAD": {
                    "LAST_DIM": 128,
                    "BLOCKS_DIM": [512, 256, 128],
                    "BN": True,
                    "NORM_DSC": True,
                    "POS_ENCODING": True,
                },
            },
            "FEATURE_MATCHER": {
                "TYPE": "DualSoftmax",
                "DUAL_SOFTMAX": {"TEMPERATURE": 0.1, "USE_DUSTBIN": True},
                "SINKHORN": {"NUM_IT": 10, "DUSTBIN_SCORE_INIT": 1.0},
                "USE_TRANSFORMER": False,
                "TOP_KEYPOINTS": False,
            },
            "LOSS_CLASS": {
                "LOSS_FUNCTION": "VCRE",
                "SOFT_CLIPPING": True,
                "POSE_ERR": {"MAX_LOSS_VALUE": 1.5, "MAX_LOSS_SOFTVALUE": 0.8},
                "VCRE": {"MAX_LOSS_VALUE": 90, "MAX_LOSS_SOFTVALUE": 0.8},
                "GENERATE_HYPOTHESES": {
                    "SCORE_TEMPERATURE": 20,
                    "IT_MATCHES": 20,
                    "IT_RANSAC": 20,
                    "INLIER_3D_TH": 0.3,
                    "INLIER_REF_TH": 0.15,
                    "NUM_REF_STEPS": 4,
                    "NUM_CORR_3d3d": 8,
                },
                "CURRICULUM_LEARNING": {
                    "TRAIN_CURRICULUM": True,
                    "TRAIN_WITH_TOPK": True,
                    "TOPK_INIT": 30,
                    "TOPK": 80,
                },
                "NULL_HYPOTHESIS": {"ADD_NULL_HYPOTHESIS": True, "TH_OUTLIERS": 0.35},
                "SAMPLER": {"NUM_SAMPLES_MATCHES": 512},
            },
            "PROCRUSTES": {
                "IT_MATCHES": 20,
                "IT_RANSAC": 100,
                "NUM_SAMPLED_MATCHES": 2048,
                "NUM_CORR_3D_3D": 3,
                "NUM_REFINEMENTS": 4,
                "TH_INLIER": 0.15,
                "TH_SOFT_INLIER": 0.3,
            },
            "PROCRUSTES_TRAINING": {"MAX_CORR_DIST": None, "REFINE": False},
            "DATASET": {
                "DATA_SOURCE": "MapFree",
                "SCENES": None,
                "DATA_ROOT": "data/",
                "SEED": 66,
                "NPZ_ROOT": None,
                "MIN_OVERLAP_SCORE": 0.2,
                "MAX_OVERLAP_SCORE": 0.7,
                "CONSECUTIVE_PAIRS": None,
                "FRAME_RATE": None,
                "AUGMENTATION_TYPE": None,
                "BLACK_WHITE": False,
                "PAIRS_TXT": {"TRAIN": None, "VAL": None, "TEST": None, "ONE_NN": False},
                "HEIGHT": 720,
                "WIDTH": 540,
            },
            "TRAINING": {
                "BATCH_SIZE": 8,
                "NUM_WORKERS": 8,
                "NATIVE_LOADER": True,
                "NUM_GPUS": 1,
                "SAMPLER": "scene_balance",
                "N_SAMPLES_SCENE": 100,
                "SAMPLE_WITH_REPLACEMENT": True,
                "LR": 1e-4,
                "LR_STEP_INTERVAL": None,
                "LR_STEP_GAMMA": None,
                "VAL_INTERVAL": 0.5,
                "VAL_BATCHES": 100,
                "LOG_INTERVAL": 50,
                "EPOCHS": 100,
                "GRAD_CLIP": 5.0,
            },
            "TPU": {
                "MESH_SHAPE": None,
                "BACKBONE_DTYPE": "bfloat16",
                "SAMPLING": "exact",
                "SAMPLING_PREFILTER": 4096,
                "USE_PALLAS_ATTENTION": True,
                "USE_PALLAS_SCORING": True,
                "HEADS_BF16": False,
                "STAGED_TRAIN": True,
                "FEATURE_CACHE": "",
                "FEATURE_CACHE_DTYPE": "bfloat16",
                "HEADS_BF16_ON_CPU": False,
                "PALLAS_INTERPRET": False,
                "ATTENTION_BLOCKS": [512, 2048],
                "SCAN_UNROLL": 2,
                "PACKED_ATTENTION": True,
                "USE_PALLAS_MATCHER": True,
                "USE_PALLAS_MATCHER_GRAD": True,
                "MATCHER_BF16": False,
                "FUSED_TOPK": True,
                "MATCHER_TOPL": 16,
                "TRAIN_FUSED_TOPK": False,
                "LOG_IMAGES": False,
                "DONATE_BUFFERS": True,
            },
        }
    )


def preset_path(name: str) -> Path:
    """The YAML preset shipped with the port, by its name under ``configs/``
    without the suffix: ``MicKey/curriculum_learning``,
    ``MicKey/curriculum_learning_warm_up``, ``MicKey/overlap_score``,
    ``MicKey/overlap_score_warm_up`` or ``datasets/mapfree``."""
    path = PRESETS / f"{name}.yaml"
    if not path.is_file():
        known = sorted(str(p.relative_to(PRESETS).with_suffix("")) for p in PRESETS.rglob("*.yaml"))
        raise FileNotFoundError(f"no preset {name!r}; the presets are {known}")
    return path


def load_config(*yaml_paths: str, overrides=None) -> Config:
    """Build a config: defaults, then YAML overlays in order, then overrides."""
    cfg = default_config()
    for p in yaml_paths:
        cfg.merge_from_file(p)
    if overrides:
        cfg.merge_from_list(overrides)
    return cfg
