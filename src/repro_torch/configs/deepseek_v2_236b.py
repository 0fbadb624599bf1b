"""deepseek-v2-236b [moe]: 60L d=5120 128H d_ff(routed)=1536 vocab=102400.
MLA kv_lora=512 (q_lora=1536, nope=128, rope=64, v=128); MoE 160 routed
top-6 + 2 shared experts; first layer dense (d_ff=12288).
[arXiv:2405.04434; hf]"""
from .base import BlockGroup, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    blocks=(BlockGroup("mla", "mlp", 1, scan=False),
            BlockGroup("mla", "moe", 59)),
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=160, experts_per_token=6, moe_d_ff=1536,
    num_shared_experts=2, first_k_dense=1,
    param_dtype="bfloat16",
    source="arXiv:2405.04434; hf",
))
