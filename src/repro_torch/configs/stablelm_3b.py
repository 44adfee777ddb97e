"""stablelm-3b  [dense]  32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304
StableLM-style: LayerNorm, partial rotary (25%).  [hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm_type="layernorm",
    rotary_pct=0.25,
    rope_theta=10_000.0,
    mlp_act="swiglu",
))
