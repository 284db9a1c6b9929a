"""llava-next-mistral-7b -- VLM, anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone: Mistral-7B (32L d_model=4096 32H GQA kv=8 d_ff=14336 vocab=32000).
The vision frontend (SigLIP/CLIP ViT + anyres tiling) is a STUB per the
assignment: ``input_specs()`` provides precomputed patch embeddings of shape
(batch, n_prefix_tokens, frontend_dim); the model owns only the 2-layer MLP
projector and the language decoder that consumes them.
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("dense",),
    attn_kind="gqa",
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    frontend="vision",
    n_prefix_tokens=576,  # one 24x24 CLIP-ViT-L/14 tile (base image)
    frontend_dim=1024,
    shard_cache_seq=True,  # SSPerf H2: kv=8 can't divide the 16-way model axis
    subquadratic=False,  # long_500k skipped (full attention; see DESIGN.md)
    fed=FederatedConfig(algorithm="gpdmm", layout="client_axis"),
    microbatch=16,  # grad-accum chunks per inner step (activation memory)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
