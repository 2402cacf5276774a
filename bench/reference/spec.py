"""A model configuration file (``bench/configs/<name>.json``) read into the
plain description that the reference, the weight generator and the work
counts share.

The file holds the model's published ``config.json`` keys at the values the
cell runs. Its ``model_type`` names the model's family, and a family plugs
into the benchmark through files of its own, each part optional but the
first, each falling back to the benchmark's own code:

- ``bench/reference/family_<model_type>.py``: ``spec(cfg, name)``, the
  parser, which may return a subclass of `ModelSpec` with the family's own
  fields; ``Model``, a subclass of `model.Model` (its router, rotary
  embedding and softmax scale, the experts a layer holds); and any
  function of `model` marked `overridable`, such as ``capacity``.
- ``bench/harness/family_<model_type>.py``: the leaves drawn
  (``weights.leaves``), the port's ``ArchConfig`` (``program.arch``) and
  its parameter tree (``program.tree``); it may import the port.
- ``bench/yardstick/family_<model_type>.py``: any count of ``work`` or
  ``kernels``, such as ``body_params`` or ``k2_products``.

A part is found by its name: a function of the benchmark marked
`overridable` is replaced by the family's function of the same name, which
takes the same arguments and reaches the benchmark's own as
``<function>.default``. A family registered in `FAMILIES` (the tests') is
used instead of files.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"
BENCH = __package__.rsplit(".", 1)[0]
# model_type -> an object holding every part of a family, used in place of
# its files
FAMILIES: Dict[str, Any] = {}


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
    rotary dims at ``rope_theta``. ``model_type`` names the family whose
    parts apply (none: the benchmark's own code throughout)."""
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
    model_type: str = ""

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


def family(model_type: str, layer: str):
    """What holds ``model_type``'s parts for ``layer`` (``reference``,
    ``harness`` or ``yardstick``): its entry in `FAMILIES`, else its file
    ``bench/<layer>/family_<model_type>.py``, else None."""
    if model_type in FAMILIES:
        return FAMILIES[model_type]
    return _module(model_type, layer) if model_type else None


@functools.lru_cache(maxsize=None)
def _module(model_type: str, layer: str):
    if not model_type.isidentifier():
        raise ValueError(f"model_type {model_type!r}")
    module = f"{BENCH}.{layer}.family_{model_type}"
    if importlib.util.find_spec(module) is None:
        return None
    return importlib.import_module(module)


def part(spec: ModelSpec, layer: str, name: str, default):
    """The family's part ``name`` for ``spec``, or ``default``."""
    fam = family(spec.model_type, layer)
    return default if fam is None else getattr(fam, name, default)


def overridable(layer: str):
    """Mark a function of ``layer`` whose first argument is a `ModelSpec`
    as a part a family may replace (the function of the same name in the
    family's file for ``layer``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(spec, *args, **kwargs):
            return part(spec, layer, fn.__name__, fn)(spec, *args, **kwargs)
        call.default = fn
        return call
    return wrap


def parse(cfg: dict, name: str) -> ModelSpec:
    """The `ModelSpec` of a configuration file's contents, by its family's
    parser."""
    model_type = cfg.get("model_type")
    if not isinstance(model_type, str) or not model_type.isidentifier():
        raise ValueError(f"{name}: model_type {model_type!r}")
    fam = family(model_type, "reference")
    if fam is None:
        raise ValueError(f"{name}: no family {model_type!r}")
    return dataclasses.replace(fam.spec(cfg, name), model_type=model_type)


def load_spec(name: str, config_dir: Path = CONFIG_DIR) -> ModelSpec:
    return parse(load_config(name, config_dir), name)


def assumed(cfg: dict, key: str):
    """A size the configuration file states under ``assumed``."""
    try:
        return cfg["assumed"][key]
    except KeyError:
        raise KeyError(f"the configuration states no assumed {key!r}") \
            from None
