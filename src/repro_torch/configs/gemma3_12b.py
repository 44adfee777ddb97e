"""gemma3-12b  [dense]  48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
5:1 local:global sliding-window pattern, 128k context, qk-norm, head_dim=256.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, ATTN),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="geglu",
    tie_embeddings=True,
))
