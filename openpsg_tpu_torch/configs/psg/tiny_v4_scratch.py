# From-scratch smoke config for the port (a copy of configs/psg/tiny_v4_scratch.py):
# tiny widths AND a trainable LLM. Without pretrained Llama weights the
# frozen-LLM recipe cannot produce text; this variant unfreezes it
# (freeze_layers omits the language model).
_base_ = ['tiny_v4_ov.py']

model = dict(
    train_cfg=dict(_delete_=True, freeze_layers=['openseed']),
)
work_dir = './work_dirs/tiny_v4_scratch'
