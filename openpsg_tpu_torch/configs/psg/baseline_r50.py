# The PyTorch/CUDA port's copy of configs/psg/baseline_r50.py,
# taking its vocabulary from the port;
# every other field is the same.
# PSG v1 baseline — Mask2Former(R50) + RelationTransformerHead.
# Field surface mirrors the reference configs/psg/baseline_r50.py; mmdet-
# specific sub-dicts (assigners, samplers) are accepted by the builder and
# ignored where XLA replaces that machinery.
from openpsg_tpu_torch.data.vocab import (
    THING_CLASSES as thing_classes,
    STUFF_CLASSES as stuff_classes,
    RELATION_CLASSES as relation_classes,
)

num_things_classes = len(thing_classes)
num_stuff_classes = len(stuff_classes)
num_object_classes = num_things_classes + num_stuff_classes
num_relation_classes = len(relation_classes)

model = dict(
    type='Mask2FormerRelation',
    backbone=dict(type='ResNet', depth=50, num_stages=4,
                  out_indices=(0, 1, 2, 3), frozen_stages=1),
    panoptic_head=dict(
        type='Mask2FormerRelationHead',
        in_channels=[256, 512, 1024, 2048],
        feat_channels=256,
        out_channels=256,
        num_things_classes=num_things_classes,
        num_stuff_classes=num_stuff_classes,
        num_queries=100,
        num_transformer_feat_level=3,
        use_pan_seg_losses=False,
    ),
    panoptic_fusion_head=dict(
        type='MaskFormerFusionRelationHead',
        num_things_classes=num_things_classes,
        num_stuff_classes=num_stuff_classes,
    ),
    relation_head=dict(
        type='RelationTransformerHead',
        pretrained_transformer='bert-base-uncased',
        input_feature_size=256,
        output_feature_size=768,
        num_transformer_layer=2,
        num_relation_classes=num_relation_classes,
        pred_type='attention',
        loss_type='v1',
        loss_weight=50.0,
        loss_alpha=1.0,
    ),
    test_cfg=dict(
        panoptic_on=True,
        object_mask_thr=0.8,
        iou_thr=0.8,
        filter_low_score=False,
        predict_relation=True,
    ),
    train_cfg=dict(freeze_layers=['backbone', 'panoptic_head']),
)

tpu = dict(
    segmenter_preset='r50',
    bf16=True,
    mesh=dict(dp=8, tp=1),
)

img_norm_cfg = dict(
    mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_rgb=True)
data = dict(
    samples_per_gpu=1,
    workers_per_gpu=2,
    train=dict(type='CocoPanopticRelationDataset',
               ann_file='./data/psg/processed/psg_tra.json',
               img_prefix='./data/coco/', seg_prefix='./data/coco/',
               pipeline=[]),
    val=dict(type='CocoPanopticRelationDataset',
             ann_file='./data/psg/processed/psg_val.json',
             img_prefix='./data/coco/', seg_prefix='./data/coco/',
             pipeline=[]),
    test=dict(type='CocoPanopticRelationDataset',
              ann_file='./data/psg/processed/psg_val.json',
              img_prefix='./data/coco/', seg_prefix='./data/coco/',
              pipeline=[]))

# paramwise multipliers (reference baseline_r50.py:277-291): backbone lr
# x0.1, query/level embeds + norms no weight decay
embed_multi = dict(lr_mult=1.0, decay_mult=0.0)
optimizer = dict(type='AdamW', lr=0.0001, weight_decay=0.05, eps=1e-8,
                 betas=(0.9, 0.999),
                 paramwise_cfg=dict(
                     custom_keys={
                         'backbone': dict(lr_mult=0.1, decay_mult=1.0),
                         'query_embed': embed_multi,
                         'query_feat': embed_multi,
                         'level_embed': embed_multi,
                     },
                     norm_decay_mult=0.0))
optimizer_config = dict(grad_clip=dict(max_norm=0.01, norm_type=2))
lr_config = dict(policy='step', warmup='linear', warmup_iters=500,
                 warmup_ratio=0.001, step=[6, 10])
runner = dict(type='EpochBasedRunner', max_epochs=12)
log_config = dict(interval=50, hooks=[dict(type='TextLoggerHook')])
checkpoint_config = dict(type='PartCheckpointHook', interval=1,
                         max_keep_ckpts=3)
evaluation = dict(metric=['PQ'])
seed = 0
work_dir = './work_dirs/psg_baseline_r50'
