"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3
from repro_torch.configs.gemma_7b import CONFIG as _gemma7b
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.falcon_mamba_7b import CONFIG as _mamba
from repro_torch.configs.llama32_vision_11b import CONFIG as _llamav
from repro_torch.configs.deepseek_v2_236b import CONFIG as _dsv2
from repro_torch.configs.phi35_moe_42b import CONFIG as _phi

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (
        _nemotron, _qwen3, _gemma7b, _gemma2, _rgemma,
        _whisper, _mamba, _llamav, _dsv2, _phi,
    )
}

ARCH_IDS = tuple(ARCHS)


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
