"""stablelm-12b -- dense GQA [hf:stabilityai/stablelm-2-1_6b family].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    block_pattern=("dense",),
    attn_kind="gqa",
    norm_kind="layernorm",
    shard_cache_seq=True,  # SSPerf H2: kv=8 can't divide the 16-way model axis
    subquadratic=False,  # long_500k skipped (full attention; see DESIGN.md)
    fed=FederatedConfig(algorithm="gpdmm", layout="client_axis"),
    microbatch=16,  # grad-accum chunks per inner step (activation memory)
    source="hf:stabilityai/stablelm-2-12b",
)
