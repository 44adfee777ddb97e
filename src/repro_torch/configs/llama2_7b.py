"""llama2-7b — the paper's own evaluation workload (§5.1): SkipGPT-pruned
Llama-2 with ~25% skipping, GPTQ int4 weights, FP16 activations.
[arXiv:2307.09288]"""
from repro_torch.configs.base import ModelConfig, QuantConfig, SkipConfig, register

CONFIG = register(ModelConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=10_000.0,
    mlp_act="swiglu",
    skip=SkipConfig(enabled=True, keep_prob=0.75),
    quant=QuantConfig(enabled=True, bits=4, group_size=128, pow2_scales=True),
))
