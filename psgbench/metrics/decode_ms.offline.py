"""The model's ``decode`` stage (one prefill and the trips over the
chunk's pairs) per image (its ``stage_times=`` span), in the traced run's
stage-timed phase; nothing where the model has no LLM stage."""


def read(ctx):
    ph = ctx["phases"].get("staged")
    if not ph or not ph["images"] or "decode" not in ph["stage_ms"]:
        return None
    return ph["stage_ms"]["decode"] / ph["images"]
