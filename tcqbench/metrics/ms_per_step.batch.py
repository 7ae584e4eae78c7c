"""Window wall time over the device steps of its batches (the lane pool's
``QueryStats.device_steps``, one count per batch)."""


def read(rec):
    steps = sum(b["device_steps"] for b in rec.get("batches", ()))
    return 1e3 * rec["window_s"] / steps if steps else None
