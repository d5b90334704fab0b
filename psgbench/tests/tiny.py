"""Tiny configurations and traffic for the CPU tests (shapes of the tiny
presets of the port's own tests; float32 throughout)."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(*parts):
    with open(os.path.join(ROOT, *parts), "r", encoding="utf-8") as f:
        return json.load(f)


def v4_config():
    c = copy.deepcopy(load("configs", "openpsg_v4_mistral7b.json"))
    c["llm"].update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                    num_key_value_heads=2, num_hidden_layers=2, vocab_size=512,
                    torch_dtype="float32")
    p = c["psg"]
    p.update(dtype="float32", test_scale=[64, 64], patch_size=4, object_feature_size=16,
             max_object_num=6, max_objects_padded=8, top_pairs=4, max_new_tokens=6,
             fusion_candidates=12, llm_max_seq_len=128)
    p["segmenter"].update(embed_dim=16, depths=[1, 1, 1, 1], num_heads=[1, 2, 2, 2], window=4,
                          dim=32, mask_dim=32, num_queries=20, enc_layers=1, dec_layers=2,
                          ffn_hidden=64, total_levels=3, proj_dim=32)
    p["qformer"].update(hidden_size=32, num_layers=2, num_heads=2, intermediate=64,
                        encoder_hidden_size=16, num_relation_queries=4)
    return c


def traffic(name="vga_landscape_mb4"):
    t = copy.deepcopy(load("traffic", name + ".json"))
    t["mix"] = [{"hw": [48, 64], "count": 4}, {"hw": [64, 48], "count": 2},
                {"hw": [64, 64], "count": 2}]
    t["group"] = 2
    return t


def v1_config():
    c = copy.deepcopy(load("configs", "openpsg_v1_r50.json"))
    m = c["model"]
    m.update(dtype="float32", test_scale=[64, 64], backbone="tiny_r50", depths=[1, 1, 1, 1],
             dim=32, mask_dim=32, num_queries=10, enc_layers=2, dec_layers=3, ffn_hidden=64,
             max_objects=6, max_objects_padded=8)
    m["head"].update(num_layers=2, num_heads=2, intermediate=64, output_feature_size=32,
                     cls_qk_size=8)
    return c
