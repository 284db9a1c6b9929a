"""yi-34b -- llama-arch dense GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

Federated layout: ``fsdp`` with m=4 clients -- 16 full dual copies of 34B
params exceed v5e HBM; see DESIGN.md SS Arch-applicability.
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=("dense",),
    attn_kind="gqa",
    rope_theta=5_000_000.0,
    norm_kind="rmsnorm",
    shard_cache_seq=True,  # SSPerf H2: kv=8 can't divide the 16-way model axis (215->15.8 GiB/dev)
    subquadratic=False,  # long_500k skipped (full attention; see DESIGN.md)
    fed=FederatedConfig(algorithm="gpdmm", layout="fsdp", num_clients=4),
    microbatch=64,  # grad-accum chunks per inner step (activation memory)
    source="arXiv:2403.04652 (Yi)",
)
