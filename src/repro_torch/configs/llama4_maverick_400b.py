"""llama4-maverick-400b-a17b -- MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 128 routed experts
top-1 + 1 shared expert, MoE interleaved every other layer (the published
Maverick layout; this is what makes 128 experts x 48L land at ~400B total /
~17B active).  Text backbone only (early-fusion frontend is out of scope per
the assignment's modality carve-out).

Federated layout: ``fsdp`` with m=4 clients -- 128 full dual copies of a 400B
model cannot fit HBM; see DESIGN.md SS Arch-applicability.
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("dense", "moe"),
    attn_kind="gqa",
    rope_theta=500_000.0,
    n_experts=128,
    n_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,
    norm_kind="rmsnorm",
    subquadratic=False,  # long_500k skipped (full attention; see DESIGN.md)
    fed=FederatedConfig(algorithm="gpdmm", layout="fsdp", num_clients=4),
    microbatch=64,  # grad-accum chunks per inner step (activation memory)
    source="hf:meta-llama/Llama-4-Maverick-17B-128E",
)
