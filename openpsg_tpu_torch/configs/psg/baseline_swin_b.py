# The PyTorch/CUDA port's copy of configs/psg/baseline_swin_b.py;
# every other field is the same.
# PSG v1 with Swin-B backbone (reference configs/psg/baseline_swin_b.py:
# inherits r50, swaps the backbone via _base_ + _delete_).
_base_ = ['baseline_r50.py']

model = dict(
    backbone=dict(
        _delete_=True,
        type='SwinTransformer',
        embed_dims=128,
        depths=[2, 2, 18, 2],
        num_heads=[4, 8, 16, 32],
        window_size=12,
        pretrain_img_size=384,
    ),
)

tpu = dict(_delete_=True, segmenter_preset='swin_b', bf16=True,
           mesh=dict(dp=8, tp=1))
work_dir = './work_dirs/psg_baseline_swin_b'
