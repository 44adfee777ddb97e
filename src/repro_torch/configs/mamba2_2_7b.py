"""mamba2-2.7b  [ssm]  64L d_model=2560 (attention-free) vocab=50280
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

KV reuse is inapplicable (no KV cache).  Token routing uses
masked-contribution semantics on the SSD recurrence: a skipped token's dt
is zeroed, so it neither updates the state nor produces output.
"""
from repro_torch.configs.base import MAMBA, ModelConfig, SkipConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,           # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                # no MLP blocks: pure Mamba stack
    vocab_size=50280,
    layer_pattern=(MAMBA,),
    ssm_state=128,
    ssm_headdim=64,
    ssm_chunk=128,
    pos_embedding="none",
    tie_embeddings=True,
    skip=SkipConfig(kv_reuse=False, route_attention=False),
))
