# The PyTorch/CUDA port's copy of configs/psg/baseline_v3_ov.py,
# taking its vocabulary from the port;
# every other field is the same.
# PSG v3 open-vocabulary — OpenSeeD segmenter + LLaMA head with predicate
# text spans as a dynamic classifier (reference configs/psg/baseline_v3_ov.py).
from openpsg_tpu_torch.data.vocab import (
    THING_CLASSES as thing_classes,
    STUFF_CLASSES as stuff_classes,
    RELATION_CLASSES as relation_classes,
)

model = dict(
    type='OpenSeeDRelation',
    openseed_config_path='',
    openseed_pretrained_path='',
    thing_classes=thing_classes,
    stuff_classes=stuff_classes,
    relation_head=dict(
        type='RelationTransformerHeadV3',
        shave_language_decoder_at=6,
        causal_mask=False,           # full attention (ref :64-70)
        ov_relation=True,
        sub_obj_merge_type='concat',
        num_in_former_layer=0,
        num_out_former_layer=0,
        relation_classes=relation_classes,
    ),
    train_cfg=dict(freeze_layers=['openseed', 'relation_head.llama_model']),
)

tpu = dict(segmenter_preset='swin_t', bf16=True, mesh=dict(dp=8, tp=1))

data = dict(
    samples_per_gpu=1,
    workers_per_gpu=2,
    train=dict(type='CocoPanopticRelationDataset',
               ann_file='./data/psg/processed/psg_tra.json',
               img_prefix='./data/coco/', seg_prefix='./data/coco/',
               pipeline=[]),
    test=dict(type='CocoPanopticRelationDataset',
              ann_file='./data/psg/processed/psg_val.json',
              img_prefix='./data/coco/', seg_prefix='./data/coco/',
              pipeline=[]))

optimizer = dict(type='AdamW', lr=0.0001, weight_decay=0.05, eps=1e-8,
                 betas=(0.9, 0.999))
optimizer_config = dict(grad_clip=dict(max_norm=0.01, norm_type=2))
lr_config = dict(policy='step', warmup='linear', warmup_iters=500,
                 warmup_ratio=0.001, step=[6, 10])
runner = dict(type='EpochBasedRunner', max_epochs=12)
log_config = dict(interval=50, hooks=[dict(type='TextLoggerHook')])
checkpoint_config = dict(type='PartCheckpointHook', interval=1,
                         max_keep_ckpts=3)
seed = 0
work_dir = './work_dirs/psg_baseline_v3_ov'
