"""idle_fwdbwd.train: Idle seconds of the traced steps' card put down to
the program's ``train.forward`` and ``train.backward`` spans (the
innermost ``train.*`` span open when each gap began,
``benchmark/program.py``), over the traced window's seconds."""

from benchmark import program

UNIT = "%"
LAYER = "loss and backward"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    return program.idle_share(
        ctx, lambda n: n in ("train.forward", "train.backward"),
        program.training)
