"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated()``
over the window's steps, set-up left out."""

UNIT = "GiB"
LAYER = "device"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    if ctx.get("peak_bytes") is None:
        return None
    return ctx["peak_bytes"] / 2 ** 30
