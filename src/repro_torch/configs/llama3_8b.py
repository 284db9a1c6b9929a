"""llama3-8b -- dense GQA, 128k vocab [arXiv:2407.21783].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  Full attention;
long_500k runs via the documented sliding-window variant (window 8192).
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=("dense",),
    attn_kind="gqa",
    rope_theta=500_000.0,
    norm_kind="rmsnorm",
    shard_cache_seq=True,  # SSPerf H2: kv=8 can't divide the 16-way model axis
    subquadratic=False,
    sw_variant_window=8192,  # long_500k uses the SW variant
    fed=FederatedConfig(algorithm="gpdmm", layout="client_axis"),
    microbatch=16,  # grad-accum chunks per inner step (activation memory)
    source="arXiv:2407.21783 (Llama 3)",
)
