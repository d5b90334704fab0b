"""The model's ``segmenter`` stage per image (its ``stage_times=`` span,
which synchronizes the card), in the traced run's stage-timed phase."""


def read(ctx):
    ph = ctx["phases"].get("staged")
    if not ph or not ph["images"] or "segmenter" not in ph["stage_ms"]:
        return None
    return ph["stage_ms"]["segmenter"] / ph["images"]
