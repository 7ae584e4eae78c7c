"""Share of the window in which no kernel, copy or set ran on the card
(from the device trace), in the batch cells."""


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else 100.0 * (1.0 - tr["busy_s"]
                                            / tr["window_s"])
