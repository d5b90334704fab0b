"""PSG class vocabularies (dataset constants; a copy of
``openpsg_tpu/data/vocab.py`` so the port imports nothing of the JAX package).

The reference duplicates these lists in four places (SURVEY.md §2.1); we keep
one canonical module.  Sources: COCO-panoptic 80 thing + 53 stuff classes and
the 56 PSG predicate classes (reference: configs/psg/baseline_v4_ov.py:15-47,
kings_sgg/datasets/coco_panoptic_relation.py:8-48,
kings_sgg/models/detectors/mask2former_relation_v2.py:23-37).

``RAW_*`` keep the mmdet/panopticapi suffixes (``-stuff/-merged/-other``);
``clean_name`` strips them for LLM prompts exactly as the reference's
``replace_name`` does (mask2former_relation_v2.py:23-30).
"""

from __future__ import annotations

from typing import List

# Reference parity: mmdet INSTANCE_OFFSET — panoptic ids are encoded
# category_id + INSTANCE_OFFSET * instance_index.
INSTANCE_OFFSET = 1000

THING_CLASSES: List[str] = [
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella', 'handbag',
    'tie', 'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite',
    'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon',
    'bowl', 'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
    'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant',
    'bed', 'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush',
]

RAW_STUFF_CLASSES: List[str] = [
    'banner', 'blanket', 'bridge', 'cardboard', 'counter', 'curtain',
    'door-stuff', 'floor-wood', 'flower', 'fruit', 'gravel', 'house', 'light',
    'mirror-stuff', 'net', 'pillow', 'platform', 'playingfield', 'railroad',
    'river', 'road', 'roof', 'sand', 'sea', 'shelf', 'snow', 'stairs', 'tent',
    'towel', 'wall-brick', 'wall-stone', 'wall-tile', 'wall-wood',
    'water-other', 'window-blind', 'window-other', 'tree-merged',
    'fence-merged', 'ceiling-merged', 'sky-other-merged', 'cabinet-merged',
    'table-merged', 'floor-other-merged', 'pavement-merged', 'mountain-merged',
    'grass-merged', 'dirt-merged', 'paper-merged', 'food-other-merged',
    'building-other-merged', 'rock-merged', 'wall-other-merged', 'rug-merged',
]


def clean_name(text: str) -> str:
    """Strip panopticapi suffixes for natural-language prompts
    (reference ``replace_name``, mask2former_relation_v2.py:23-30)."""
    for suffix in ('-stuff', '-merged', '-other'):
        if suffix in text:
            text = text.replace(suffix, '')
    return text


STUFF_CLASSES: List[str] = [clean_name(x) for x in RAW_STUFF_CLASSES]

RAW_OBJECT_CLASSES: List[str] = THING_CLASSES + RAW_STUFF_CLASSES
# Clean names used for all LLM/Q-Former prompts (reference object_categories).
OBJECT_CLASSES: List[str] = THING_CLASSES + STUFF_CLASSES

RELATION_CLASSES: List[str] = [
    'over', 'in front of', 'beside', 'on', 'in', 'attached to',
    'hanging from', 'on back of', 'falling off', 'going down', 'painted on',
    'walking on', 'running on', 'crossing', 'standing on', 'lying on',
    'sitting on', 'flying over', 'jumping over', 'jumping from', 'wearing',
    'holding', 'carrying', 'looking at', 'guiding', 'kissing', 'eating',
    'drinking', 'feeding', 'biting', 'catching', 'picking', 'playing with',
    'chasing', 'climbing', 'cleaning', 'playing', 'touching', 'pushing',
    'pulling', 'opening', 'cooking', 'talking to', 'throwing', 'slicing',
    'driving', 'riding', 'parked on', 'driving on', 'about to hit', 'kicking',
    'swinging', 'entering', 'exiting', 'enclosing', 'leaning on',
]

NUM_THING_CLASSES = len(THING_CLASSES)          # 80
NUM_STUFF_CLASSES = len(STUFF_CLASSES)          # 53
NUM_OBJECT_CLASSES = NUM_THING_CLASSES + NUM_STUFF_CLASSES  # 133
NUM_RELATION_CLASSES = len(RELATION_CLASSES)    # 56

assert NUM_THING_CLASSES == 80
assert NUM_STUFF_CLASSES == 53
assert NUM_RELATION_CLASSES == 56
