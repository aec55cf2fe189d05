"""idle_update.train: Idle seconds of the traced steps' card put down to
the program's ``train.update`` spans (the gradient norm, the clip test's
host read of it, the learning rate and AdamW; ``benchmark/program.py``),
over the traced window's seconds."""

from benchmark import program

UNIT = "%"
LAYER = "trainer"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    return program.idle_share(ctx, lambda n: n == "train.update",
                              program.training)
