"""recurrentgemma-9b -- Griffin-style hybrid: RG-LRU + local attn, 1:2
[arXiv:2402.19427].

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.  Pattern is two
recurrent blocks followed by one local-attention block (window 2048).
38 = 12 full (rec,rec,local) units + 2 trailing rec blocks.
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "local"),
    attn_kind="gqa",
    window=2048,
    rec_d_state=4096,
    conv_width=4,
    norm_kind="rmsnorm",
    act="gelu",
    subquadratic=True,  # local attention window + O(1) recurrence
    fed=FederatedConfig(algorithm="gpdmm", layout="client_axis"),
    microbatch=4,  # grad-accum chunks per inner step (activation memory)
    source="arXiv:2402.19427 (RecurrentGemma / Griffin)",
)
