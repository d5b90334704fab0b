"""Predicate text descriptions for prompt-based relation heads (a copy of
``openpsg_tpu/data/predicate_descriptions.py`` and its asset, so the port
imports nothing of the JAX package).

The reference ships three selectable ``semantic_type`` vocabularies
(kings_sgg/datasets/coco_panoptic_relation.py:49-114), consumed by head
v1's predicate-prompt path (relation_transformer_head.py:54):

  * ``relation_classes``            — the bare 56 predicate names;
  * ``relation_description_v1``     — the template
    'The relationship between two objects is "{name}"';
  * ``relation_description_gpt4_v0``— 56 GPT-4-written paragraph
    definitions (~1 KB each).  Those are offline-generated *data* shipped
    in-repo by the reference; we vendor them verbatim as
    ``assets/relation_description_gpt4_v0.json`` and load that by default,
    so reference prompts reproduce without env vars.  A custom asset path
    (``gpt4_asset_path`` arg or ``PSG_GPT4_DESCRIPTIONS`` env) overrides;
    a structured template remains as last-resort fallback for truncated
    vocabularies where the 56-entry asset doesn't apply.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from openpsg_tpu_torch.data.vocab import RELATION_CLASSES

_FALLBACK_TEMPLATE = (
    '"{name}" is a relationship between two objects in an image, where the '
    "subject is {name} the object; it describes how the subject and the "
    "object are arranged or interact in the scene."
)

# Vendored reference data (coco_panoptic_relation.py:49-106): 56 paragraph
# descriptions, one per RELATION_CLASSES entry, in vocabulary order.
_GPT4_ASSET = os.path.join(
    os.path.dirname(__file__), "assets", "relation_description_gpt4_v0.json"
)


def get_descriptions(
    semantic_type: str = "relation_classes",
    relation_names: Optional[List[str]] = None,
    gpt4_asset_path: Optional[str] = None,
) -> List[str]:
    names = list(relation_names or RELATION_CLASSES)
    if semantic_type == "relation_classes":
        return names
    if semantic_type == "relation_description_v1":
        return [f'The relationship between two objects is "{n}"' for n in names]
    if semantic_type == "relation_description_gpt4_v0":
        path = (
            gpt4_asset_path
            or os.environ.get("PSG_GPT4_DESCRIPTIONS", "")
            or _GPT4_ASSET
        )
        if path and os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            desc = data["descriptions"] if isinstance(data, dict) else data
            if len(desc) == len(names):
                return list(desc)
            if relation_names is None:
                raise AssertionError((len(desc), len(names)))
            # Truncated vocabulary: pick matching entries by canonical
            # index — only meaningful when the asset IS the canonical
            # 56-entry list (a custom-length asset has its own unknown
            # ordering; indexing it with canonical positions would crash
            # or silently return another vocabulary's descriptions).
            idx = {n: i for i, n in enumerate(RELATION_CLASSES)}
            if len(desc) == len(RELATION_CLASSES) and all(
                n in idx for n in names
            ):
                return [desc[idx[n]] for n in names]
        return [_FALLBACK_TEMPLATE.format(name=n) for n in names]
    raise KeyError(semantic_type)


def description_dict(relation_names: Optional[List[str]] = None) -> Dict[str, List[str]]:
    """Reference-parity mapping (coco_panoptic_relation.py:110-114)."""
    return {
        k: get_descriptions(k, relation_names)
        for k in (
            "relation_classes",
            "relation_description_v1",
            "relation_description_gpt4_v0",
        )
    }
