"""olmo-1b -- dense, non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.  OLMo uses non-parametric
LayerNorm (no scale/bias) and tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    block_pattern=("dense",),
    attn_kind="gqa",
    norm_kind="nonparam_ln",
    tie_embeddings=True,
    act="silu",
    subquadratic=False,  # long_500k skipped (full attention; see DESIGN.md)
    fed=FederatedConfig(algorithm="gpdmm", layout="client_axis"),
    microbatch=4,  # grad-accum chunks per inner step (activation memory)
    source="arXiv:2402.00838 (OLMo)",
)
