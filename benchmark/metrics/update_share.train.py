"""update_share.train: Device seconds of the work launched inside the
program's ``train.update`` spans (norm, clip, AdamW), over all device
seconds of the traced steps."""

from benchmark import program

UNIT = "%"
LAYER = "trainer"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    return program.launched_share(ctx, "train.update")
