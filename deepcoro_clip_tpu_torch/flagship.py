"""Flagship and tiny configurations, with the JAX package's values.

CoroViT-B/2x16x16: dim 512, depth 12, 4 heads (Dh 128), 16x224x224 input
-> 8x14x14 = 1568 tokens + CLS, a 2x2 token pool at block 3 (393 tokens
after it). Text tower: BERT-base shape (dim 768, depth 12) with 6 heads of
128, so its attention runs the packed kernel.
"""

from __future__ import annotations

from deepcoro_clip_tpu_torch.configs import ClipConfig


def flagship_config(**overrides) -> ClipConfig:
    d = dict(
        pipeline_project="DeepCORO_clip",
        model_name="mvit",
        frames=16,
        stride=2,
        resize=224,
        batch_size=8,
        multi_video=False,
        num_videos=1,
        vit_dim=512,
        vit_depth=12,
        vit_heads=4,
        vit_patch=[2, 16, 16],
        vit_pool_stages=[3],
        use_cls_token=True,
        embedding_dim=512,
        num_heads=8,
        aggregator_depth=2,
        dropout=0.1,
        text_dim=768,
        text_depth=12,
        text_heads=6,
        text_vocab_size=30522,
        max_text_length=512,
        temperature=0.0588,
        lr=1e-4,
        optimizer="AdamW",
        scheduler_name="cosine_with_warmup",
        loss_name="contrastive",
        precision="bf16",
        use_pallas_attention=True,
        patch_wire=True,
        epochs=30,
    )
    d.update(overrides)
    return ClipConfig.from_dict(d)


def tiny_config(**overrides) -> ClipConfig:
    """Small shapes for CPU tests."""
    d = dict(
        frames=4,
        resize=32,
        batch_size=8,
        multi_video=True,
        num_videos=2,
        vit_dim=64,
        vit_depth=2,
        vit_heads=2,
        vit_patch=[2, 16, 16],
        text_dim=64,
        text_depth=2,
        text_heads=2,
        text_vocab_size=256,
        max_text_length=16,
        embedding_dim=32,
        num_heads=2,
        aggregator_depth=1,
        dropout=0.0,
        lr=1e-3,
        precision="fp32",
        use_pallas_attention=False,
        epochs=1,
    )
    d.update(overrides)
    return ClipConfig.from_dict(d)
