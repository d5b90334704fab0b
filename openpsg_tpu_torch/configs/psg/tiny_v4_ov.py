# Tiny smoke-test variant of the port's baseline_v4_ov: same topology, minimal
# widths (a copy of configs/psg/tiny_v4_ov.py). Used by the CPU tests.
_base_ = ['baseline_v4_ov.py']

tpu = dict(
    _delete_=True,
    segmenter_preset='tiny',
    head_preset='tiny',
    llm_preset='tiny',
    llm_layers=2,
    bf16=False,
    mesh=dict(dp=8, tp=1),
)
