"""moe_share.sample: In one short request run eagerly under the profiler
before the traced request (its chain's first residues at the window's
batch shape, ``runners/sample_block.py``: a replayed graph's kernels fall
outside the program's spans, an eager forward's inside them), the device
seconds of the work launched inside the program's ``moe.experts`` spans
(the expert products and their activation, ``nn/moe.py``) over the busy
seconds of its sampling."""

UNIT = "%"
LAYER = "model step"
MOVES = "conf_per_s"


def read(ctx: dict):
    eager = ctx.get("eager")
    if not eager or eager["busy_s"] <= 0:
        return None
    return 100.0 * eager["experts_s"] / eager["busy_s"]
