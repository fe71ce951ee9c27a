"""The five LM architectures (port of ``repro/configs/lm_archs.py``, the
reference's configs unchanged).

d_head derivations: d_model / n_heads unless the source specifies
otherwise (mistral-large: 12288/96 = 128; codeqwen: 4096/32 = 128;
stablelm-12b: 5120/32 = 160; moonshot: 2048/16 = 128; grok: 6144/48 = 128).
"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

from .base import LM_SHAPES, ArchSpec

MISTRAL_LARGE_123B = ArchSpec(
    name="mistral-large-123b",
    family="lm",
    source="hf:mistralai/Mistral-Large-Instruct-2407 (unverified)",
    model_cfg=TransformerConfig(
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
        d_ff=28672, vocab=32768, rope_theta=1e6, dtype="bfloat16",
        q_chunk=512, kv_chunk=1024),
    shapes=LM_SHAPES,
)

CODEQWEN15_7B = ArchSpec(
    name="codeqwen1.5-7b",
    family="lm",
    source="hf:Qwen/CodeQwen1.5-7B (qwen1.5 arch)",
    model_cfg=TransformerConfig(
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
        d_ff=13440, vocab=92416, rope_theta=1e6, dtype="bfloat16",
        q_chunk=512, kv_chunk=1024),
    shapes=LM_SHAPES,
)

STABLELM_12B = ArchSpec(
    name="stablelm-12b",
    family="lm",
    source="hf:stabilityai/stablelm-2-12b",
    model_cfg=TransformerConfig(
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=160,
        d_ff=13824, vocab=100352, rope_theta=1e6, dtype="bfloat16",
        q_chunk=512, kv_chunk=1024),
    shapes=LM_SHAPES,
)

MOONSHOT_V1_16B_A3B = ArchSpec(
    name="moonshot-v1-16b-a3b",
    family="moe_lm",
    source="hf:moonshotai/Moonlight-16B-A3B (64e top-6)",
    model_cfg=TransformerConfig(
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=0, vocab=163840, rope_theta=1e6, dtype="bfloat16",
        q_chunk=512, kv_chunk=1024,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408)),
    shapes=LM_SHAPES,
)

GROK_1_314B = ArchSpec(
    name="grok-1-314b",
    family="moe_lm",
    source="hf:xai-org/grok-1 (8e top-2, unverified)",
    model_cfg=TransformerConfig(
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=0, vocab=131072, rope_theta=1e6, dtype="bfloat16",
        q_chunk=512, kv_chunk=1024,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768)),
    shapes=LM_SHAPES,
)

LM_ARCHS = (MISTRAL_LARGE_123B, CODEQWEN15_7B, STABLELM_12B,
            MOONSHOT_V1_16B_A3B, GROK_1_314B)
