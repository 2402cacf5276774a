"""falcon-mamba-7b [ssm] — pure Mamba-1, attention-free. [arXiv:2410.05355]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    d_model=4096,
    vocab_size=65024,
    segments=(Segment((LayerSpec("ssm", "none"),), 64),),
    d_ff=0,                            # mamba block carries its own channel mix
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    use_rope=False,
    source="arXiv:2410.05355; unverified",
    notes="sub-quadratic: O(1) recurrent state -> long_500k runs; "
          "paper-technique caveat: A_log/dt params excluded from aggressive "
          "quantization (DESIGN.md §6)",
)
