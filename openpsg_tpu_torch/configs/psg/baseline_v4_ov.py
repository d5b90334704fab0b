# PSG v4 open-vocabulary baseline for the PyTorch/CUDA port: a copy of
# configs/psg/baseline_v4_ov.py that takes its vocabulary from the port and
# names the port's modules in custom_imports; every other field is the same.
from openpsg_tpu_torch.data.vocab import (
    THING_CLASSES as thing_classes,
    STUFF_CLASSES as stuff_classes,
    RELATION_CLASSES as relation_classes,
)

file_dir = './data/psg/processed/'
data_dir = './data/coco/'
load_from = None
resume_from = None
work_dir = './work_dirs/ov_psg_baseline'

custom_imports = dict(imports=[
    'openpsg_tpu_torch.models.detectors.psg_v4',
    'openpsg_tpu_torch.data.preprocess',
], allow_failed_imports=False)

num_things_classes = len(thing_classes)      # 80
num_stuff_classes = len(stuff_classes)       # 53
num_object_classes = num_things_classes + num_stuff_classes
num_relation_classes = len(relation_classes)  # 56

model = dict(
    type='OpenSeeDRelationV2',
    # checkpoint paths are optional on TPU: run tools/convert_openseed.py on
    # the published model_state_dict_swint_51.2ap.pt to produce
    # segmenter.msgpack + class_embeds.npy, then point these at them
    openseed_config_path='',
    openseed_pretrained_path='',
    precomputed_class_embeds='',
    thing_classes=thing_classes,
    stuff_classes=stuff_classes,
    relation_head=dict(
        type='RelationTransformerHeadV4',
        qformer_model_name='Salesforce/instructblip-vicuna-7b',
        llm_model_name='meta-llama/Llama-2-7b-hf',
        relation_classes=relation_classes,
    ),
    train_cfg=dict(
        freeze_layers=['openseed', 'relation_head.language_model'],
    ),
    test_cfg=None,
    init_cfg=None)

# TPU sizing knobs (no reference equivalent — selects architecture presets)
tpu = dict(
    segmenter_preset='swin_t',
    llm_preset='llama2_7b',
    bf16=True,
    mesh=dict(dp=2, tp=4),  # v5e-8 default: 2-way data x 4-way tensor
)

# dataset ----------------------------------------------------------------
image_size = (512, 512)
img_norm_cfg = dict(
    mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_rgb=True)
train_pipeline = [
    dict(type='LoadImageFromFile', to_float32=True),
    dict(type='LoadPanopticRelationAnnotations',
         with_bbox=True, with_mask=True, with_seg=True, with_rel=True),
    dict(type='RandomFlip', flip_ratio=0.5),
    dict(type='Resize', img_scale=[(1500, 400), (1500, 1400)],
         multiscale_mode='range', keep_ratio=True),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size_divisor=32),
]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=(1333, 800), flip=False,
         transforms=[
             dict(type='Resize', keep_ratio=True),
             dict(type='Normalize', **img_norm_cfg),
             dict(type='Pad', size_divisor=32),
         ]),
]
dataset_type = 'CocoPanopticRelationDataset'
data = dict(
    samples_per_gpu=1,
    workers_per_gpu=2,
    train=dict(type=dataset_type, ann_file=f'{file_dir}/psg_tra.json',
               img_prefix=data_dir, seg_prefix=data_dir,
               pipeline=train_pipeline),
    val=dict(type=dataset_type, ann_file=f'{file_dir}/psg_val.json',
             img_prefix=data_dir, seg_prefix=data_dir,
             pipeline=test_pipeline),
    test=dict(type=dataset_type, ann_file=f'{file_dir}/psg_val.json',
              img_prefix=data_dir, seg_prefix=data_dir,
              pipeline=test_pipeline))

# optimizer / schedule (reference values) --------------------------------
optimizer = dict(type='AdamW', lr=0.0001, weight_decay=0.05, eps=1e-8,
                 betas=(0.9, 0.999))
optimizer_config = dict(grad_clip=dict(max_norm=0.01, norm_type=2))
lr_config = dict(policy='step', warmup='linear', warmup_iters=500,
                 warmup_ratio=0.001, step=[6, 10])
runner = dict(type='EpochBasedRunner', max_epochs=12)

log_level = 'INFO'
log_config = dict(interval=50, hooks=[dict(type='TextLoggerHook')])
workflow = [('train', 1)]
checkpoint_config = dict(type='PartCheckpointHook', interval=1,
                         max_keep_ckpts=3)
evaluation = dict(metric=['PQ'], classwise=True)
find_unused_parameters = True
seed = 0
