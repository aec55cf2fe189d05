"""flash_roofline.sample: The least time of every flash call of the traced request, from its
shapes and lengths (``counts.flash_call_bound_s``), over the device
seconds of the flash kernels in its trace."""

from benchmark import harness

UNIT = "%"
LAYER = "kernels"
MOVES = "conf_per_s"


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None:
        return None
    busy = tr.device_s(lambda n: harness.kind(n) == "flash kernel")
    if busy <= 0 or not ctx.get("flash_bound_s"):
        return None
    return 100.0 * ctx["flash_bound_s"] / busy
