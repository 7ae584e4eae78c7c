"""The wave steps' share of the HBM roofline: the bytes every device step
of the window needs (``roofline.step_bytes``, over the edges, pairs and
vertices of each batch's own windows) over 3.35 TB/s, divided by the
device's busy time in the trace."""

from tcqbench.roofline import HBM_BYTES_PER_S, batch_bytes


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec.get("batches") or tr["busy_s"] <= 0:
        return None
    return 100.0 * batch_bytes(rec["batches"], rec["edges"]) \
        / HBM_BYTES_PER_S / tr["busy_s"]
