"""A model configuration file (``bench/configs/<name>.json``) read into the
plain description that the reference, the weight generator and the work
counts share.

The file holds the model's published ``config.json`` keys at the values the
cell runs. Its ``model_type`` names a parser, ``family_<model_type>.py``
beside this file, which turns those keys into a `ModelSpec`; a later
configuration of another family adds its own parser file.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Optional, Tuple

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


@dataclasses.dataclass(frozen=True)
class MLA:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class MoE:
    num_experts: int
    top_k: int
    d_expert: int
    d_shared: int              # the shared experts as one SwiGLU (0: none)
    capacity_factor: float


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One decoder-only LM: a run of dense-FFN layers, then MoE layers.

    Every block is pre-norm: RMSNorm (scale applied as 1 + w, eps
    ``rms_eps``), attention (GQA with rotary q and k, or MLA), residual,
    RMSNorm, SwiGLU FFN or MoE, residual; then a final RMSNorm and an
    untied LM head. Rotary embeddings rotate the two halves of a head's
    rotary dims at ``rope_theta``."""
    name: str
    vocab_size: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int              # q/k head dim (MLA: nope + rope)
    n_dense: int               # leading layers with a dense FFN
    n_moe: int                 # layers after them with an MoE FFN
    d_ff: int                  # the dense FFN's width
    rope_theta: float
    rms_eps: float
    mla: Optional[MLA]
    moe: Optional[MoE]
    dtype: str = "bfloat16"

    @property
    def num_layers(self) -> int:
        return self.n_dense + self.n_moe

    @property
    def v_head_dim(self) -> int:
        return self.mla.v_head_dim if self.mla else self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        return ("dense",) * self.n_dense + ("moe",) * self.n_moe


def load_config(name: str, config_dir: Path = CONFIG_DIR) -> dict:
    path = config_dir / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration file {path}")
    return json.loads(path.read_text())


def parse(cfg: dict, name: str) -> ModelSpec:
    """The `ModelSpec` of a configuration file's contents."""
    model_type = cfg.get("model_type")
    if not isinstance(model_type, str) or not model_type.isidentifier():
        raise ValueError(f"{name}: model_type {model_type!r}")
    family = importlib.import_module(f"{__package__}.family_{model_type}")
    return family.spec(cfg, name)


def load_spec(name: str, config_dir: Path = CONFIG_DIR) -> ModelSpec:
    return parse(load_config(name, config_dir), name)


def assumed(cfg: dict, key: str):
    """A size the configuration file states under ``assumed``."""
    try:
        return cfg["assumed"][key]
    except KeyError:
        raise KeyError(f"the configuration states no assumed {key!r}") \
            from None
