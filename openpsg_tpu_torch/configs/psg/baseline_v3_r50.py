# The PyTorch/CUDA port's copy of configs/psg/baseline_v3_r50.py;
# every other field is the same.
# PSG v3 — truncated-LLaMA relation encoder, closed vocab
# (reference configs/psg/baseline_v3_r50.py).
_base_ = ['baseline_r50.py']

model = dict(
    type='Mask2FormerRelationV2',
    relation_head=dict(
        _delete_=True,
        type='RelationTransformerHeadV3',
        llama_model_path='./work_dirs/checkpoints/llama2/llama-2-7b-chat',
        llama_tokenizer_path='./work_dirs/checkpoints/llama2/tokenizer.model',
        shave_language_decoder_at=6,
        causal_mask=True,
        ov_relation=False,
        input_feature_size=256,
        num_relation_classes=56,
    ),
)
work_dir = './work_dirs/psg_baseline_v3_r50'
