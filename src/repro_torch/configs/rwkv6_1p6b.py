"""rwkv6-1.6b -- Finch, data-dependent decay, attention-free [arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536.  Pure SSM-style recurrence: runs
long_500k natively (O(1) decode state).
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads = d_model / wkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    attn_kind="none",
    wkv_head_dim=64,
    norm_kind="layernorm",
    subquadratic=True,
    fed=FederatedConfig(algorithm="gpdmm", layout="client_axis"),
    microbatch=4,  # grad-accum chunks per inner step (activation memory)
    source="arXiv:2404.05892 (RWKV-6 Finch)",
)
