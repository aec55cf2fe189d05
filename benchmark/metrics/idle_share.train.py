"""idle_share.train: The share of the traced steps' window in which no kernel, copy or fill
ran on the card (the union of their intervals)."""

UNIT = "%"
LAYER = "device"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or ctx["trace"].window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
