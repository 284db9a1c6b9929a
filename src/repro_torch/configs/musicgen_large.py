"""musicgen-large -- decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048, 4 parallel codebooks with
the delay interleaving pattern.  The EnCodec conv codec is a STUB per the
assignment: the model consumes 4 token streams (summed codebook embeddings)
and emits 4 per-codebook heads.
"""
from repro_torch.configs.base import ArchConfig, FederatedConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=("dense",),
    attn_kind="gqa",
    norm_kind="layernorm",
    act="gelu",
    frontend="audio",
    n_codebooks=4,
    subquadratic=False,  # long_500k skipped (full attention; see DESIGN.md)
    fed=FederatedConfig(algorithm="gpdmm", layout="client_axis"),
    microbatch=8,  # grad-accum chunks per inner step (activation memory)
    source="arXiv:2306.05284 (MusicGen)",
)
