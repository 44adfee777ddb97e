"""grok-1-314b  [moe]  64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072
MoE 8 experts top-2 every layer.  [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    top_k=2,
    moe_every=1,
    mlp_act="geglu",
))
