"""Target hardware constants, per card, the counterpart of
`repro.roofline.hw`: the same `HWSpec` fields, and an entry for the card
the port runs on. Every value is the spec sheet's, not a measurement."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops: float          # bf16 FLOP/s per card
    hbm_bw: float              # bytes/s per card
    ici_bw: float              # bytes/s per link, one direction
    ici_links: int             # links per card
    hbm_bytes: float           # device memory per card
    vmem_bytes: float          # on-chip memory one core addresses


# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, from the spec
# sheet: dense bf16 on the tensor cores; HBM3 at 3.35 TB/s; 80 GB of
# device memory; 228 KiB of shared memory an SM; NVLink 4, 18 links of
# 25 GB/s a direction (450 GB/s a direction in all). A card set below
# 700 W reaches less.
H100 = HWSpec(
    name="h100-sxm5-80gb",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=25e9,
    ici_links=18,
    hbm_bytes=80e9,
    vmem_bytes=228 * 2 ** 10,
)
