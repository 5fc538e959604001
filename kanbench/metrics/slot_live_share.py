"""slot_live_share: the share of the fused decode tick's slots that held a
decoding request, over the whole window: the engine's ``EngineStats``
``occupancy_ticks`` over ``decode_ticks`` times ``n_slots`` (a slot still
consuming its prompt, or free, flows through the tick as padding)."""


def read(ctx):
    e = getattr(ctx, "engine", None)
    if not e or not e.get("decode_ticks"):
        return None
    return 100.0 * e["occupancy_ticks"] / (e["decode_ticks"] * e["n_slots"])
