"""outside_trunk_share.sample: Device seconds of the work launched inside the sampling calls but outside
the trunk's forwards (the ``bench.trunk`` ranges of the forward hooks),
over the device seconds of all work launched inside the sampling calls,
in the traced request."""

UNIT = "%"
LAYER = "sampler loop"
MOVES = "conf_per_s"


def read(ctx: dict):
    tr = ctx.get("trace")
    if tr is None:
        return None
    inside = tr.launched_in("sample")
    if inside <= 0:
        return None
    trunk = tr.launched_in("trunk")
    return 100.0 * (inside - trunk) / inside
