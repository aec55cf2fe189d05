"""nonmatmul_share.train: Device seconds of the kernels that are neither products nor the attention
kernel (the frozen kinds of ``harness.KINDS``), over all device seconds,
in the traced steps."""

from benchmark import harness

UNIT = "%"
LAYER = "loss and backward"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None or tr.device_s() <= 0:
        return None
    other = tr.device_s(lambda n: harness.kind(n) not in
                        ("products", "flash kernel"))
    return 100.0 * other / tr.device_s()
