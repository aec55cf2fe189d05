"""moe_roofline.sample: The least time of the expert products of one
short request run eagerly under the profiler (``moe_share.sample``'s
request), from what they must move (``counts_sdar.expert_bound_s`` of the
program's ``moe.experts_hit`` and ``moe.tokens_routed``: whatever
implements them), over the device seconds of the work launched inside the
program's ``moe.experts`` spans there."""

from benchmark import counts_sdar

UNIT = "%"
LAYER = "kernels"
MOVES = "conf_per_s"


def read(ctx: dict):
    eager = ctx.get("eager")
    if (not eager or not eager.get("experts_hit")
            or not eager.get("tokens_routed") or eager["experts_s"] <= 0):
        return None
    return 100.0 * counts_sdar.expert_bound_s(
        ctx["config"], eager["experts_hit"], eager["tokens_routed"]) \
        / eager["experts_s"]
