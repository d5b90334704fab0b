# The PyTorch/CUDA port's copy of configs/psg/baseline_r50_prompt.py;
# every other field is the same.
# v1 predicate-prompt variant: predicate GPT-4 descriptions encoded by a
# semantic text tower, fused with object tokens via InteractiveFusionModule
# (reference surface: relation_transformer_head.py:54 use_relation_prompts +
# semantic_type; :193-205 forward path; fusion scoring mode selected by
# pred_type on this path).
_base_ = ['baseline_r50.py']

model = dict(
    relation_head=dict(
        use_relation_prompts=True,
        semantic_type='relation_description_gpt4_v0',
        pred_type='einsum_v2',
    ),
)
work_dir = './work_dirs/psg_baseline_r50_prompt'
