# The PyTorch/CUDA port's copy of configs/psg/baseline_v2_r50.py;
# every other field is the same.
# PSG v2 — Mask2FormerRelationV2 + RelationTransformerHeadV2 (multi-expert
# head with offline text features; reference configs/psg/baseline_v2_r50.py).
_base_ = ['baseline_r50.py']

model = dict(
    type='Mask2FormerRelationV2',
    relation_head=dict(
        _delete_=True,
        type='RelationTransformerHeadV2',
        input_feature_size=256,
        output_feature_size=768,
        num_transformer_layer=2,
        num_relation_classes=56,
        # expert switches, reference field names (baseline_v2_r50.py:150-155;
        # only object_vision_only ships enabled)
        use_object_vision_only=True,
        use_pair_vision_only=False,
        use_pair_text_vision_cross=False,
        use_pair_vision_text_cross=False,
        use_triplet_vision_text_cross=False,
        use_moe=False,
    ),
    text_info_db_dir='./data/psg/openai/gpt-3.5-turbo',
    text_embed_db_dir='./data/psg/openai/gpt-3.5-turbo_text-embedding-ada-002',
    text_embedding_size=1536,
)
work_dir = './work_dirs/psg_baseline_v2_r50'
