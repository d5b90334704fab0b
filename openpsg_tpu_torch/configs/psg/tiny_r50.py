# The PyTorch/CUDA port's copy of configs/psg/tiny_r50.py;
# every other field is the same.
_base_ = ['baseline_r50.py']
tpu = dict(_delete_=True, segmenter_preset='tiny', head_preset='tiny',
           llm_preset='tiny', bf16=False, mesh=dict(dp=8, tp=1))
