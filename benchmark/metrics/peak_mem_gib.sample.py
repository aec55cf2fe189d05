"""peak_mem_gib.sample: ``torch.cuda.max_memory_allocated()`` over the
window's requests, set-up and the watch's copies left out
(``runners/sample.py``)."""

UNIT = "GiB"
LAYER = "device"
MOVES = "conf_per_s"


def read(ctx: dict):
    if ctx.get("peak_bytes") is None:
        return None
    return ctx["peak_bytes"] / 2 ** 30
