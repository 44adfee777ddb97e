"""arctic-480b  [moe]  35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000
MoE 128 experts top-2 + dense residual branch.  [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    moe_every=1,
    dense_residual=True,
    mlp_act="swiglu",
))
