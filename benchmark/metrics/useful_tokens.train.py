"""useful_tokens.train: The real tokens of the traced steps' batches
(``train.tokens_real``: the batch's mask) over the tokens their rows hold
(``train.tokens_run``: batch x pack length), counted by the program's
data path as it builds each batch (the sum over the steps' root spans,
``benchmark/program.py``)."""

from benchmark import program

UNIT = "%"
LAYER = "trainer data"
MOVES = "train_tokens_per_s"


def read(ctx: dict):
    return program.counter_share(ctx, "train.tokens_real",
                                 "train.tokens_run")
