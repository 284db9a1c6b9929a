"""deepseek-v2-lite-16b -- MLA kv_lora=512, shared + routed top-6 experts
[arXiv:2405.04434].

27L d_model=2048 16H d_ff=1408(per expert) vocab=102400, MoE 64 routed experts
top-6 + 2 shared, first layer dense (d_ff 10944).  MLA compressed-KV cache.

Note: the assignment line reads "MoE 64e top-6" and "2 shared+160 routed"; the
published v2-Lite card has 64 routed + 2 shared, which we follow (the 160
figure belongs to full V2's 160 routed experts).  Recorded in DESIGN.md.
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,  # MLA: all heads share the compressed cache
    d_ff=10944,  # dense-layer hidden (layer 0)
    vocab_size=102400,
    block_pattern=("moe",),
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=0,  # v2-lite has no q compression
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    norm_kind="rmsnorm",
    fed=FederatedConfig(algorithm="gpdmm", layout="client_axis"),
    moe_fused_dispatch=True,  # SSPerf H1: single top-k dispatch (-47% train FLOPs)
    shard_cache_seq=True,  # SSPerf H2: MLA compressed cache seq-sharded over "model"
    microbatch=4,  # grad-accum chunks per inner step (activation memory)
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
)
