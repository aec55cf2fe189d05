"""optimizer_share.train: Device seconds of the optimizer's kernels (the frozen kinds of
``harness.KINDS``), over all device seconds, in the traced steps."""

from benchmark import harness

UNIT = "%"
LAYER = "trainer"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or tr.device_s() <= 0:
        return None
    return 100.0 * tr.device_s(lambda n: harness.kind(n) == "optimizer") \
        / tr.device_s()
