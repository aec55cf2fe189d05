"""mfu.train: Forward and backward FLOPs of the window's real tokens
(``counts.train_step_flops``: remat's recompute left out), over the
window's seconds and the H100's 989 TFLOP/s in bf16."""

from benchmark import counts

UNIT = "%"
LAYER = "model step in training"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    if not ctx.get("work_flops"):
        return None
    return 100.0 * ctx["work_flops"] / (ctx["window_s"]
                                        * counts.PEAK_BF16_FLOPS)
