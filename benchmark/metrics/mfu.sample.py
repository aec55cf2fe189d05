"""mfu.sample: The work of the completed requests, counted from the requests alone
(``counts.sample_request_flops``), over the window's seconds and the
H100's 989 TFLOP/s in bf16."""

from benchmark import counts

UNIT = "%"
LAYER = "model step"
MOVES = "conf_per_s"


def read(ctx: dict):
    if not ctx.get("work_flops"):
        return None
    return 100.0 * ctx["work_flops"] / (ctx["window_s"]
                                        * counts.PEAK_BF16_FLOPS)
