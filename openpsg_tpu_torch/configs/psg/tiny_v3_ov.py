# The PyTorch/CUDA port's copy of configs/psg/tiny_v3_ov.py;
# every other field is the same.
# Tiny v3 open-vocabulary smoke variant: full baseline_v3_ov surface at
# test scale (64px tiny segmenter + 2-layer tiny LLaMA trunk; the tiny
# preset also shrinks max_objects to 6/8).  Used by
# tools/selfcheck_openset.py — override
# ``model.relation_head.relation_classes`` in a derived config to train
# on a predicate subset and infer with extended names.
_base_ = ['baseline_v3_ov.py']

tpu = dict(_delete_=True, segmenter_preset='tiny', head_preset='tiny',
           llm_preset='tiny', bf16=False, mesh=dict(dp=8, tp=1))
