"""useful_positions.sample: The real positions of the traced request's
trunk forwards (``trunk.positions_valid``: sample rows, not surplus rows,
up to each row's length) over the positions they ran
(``trunk.positions_run``: B x L), counted by the program from its
host-side rows (the sum over the request's root spans,
``benchmark/program.py``)."""

from benchmark import program

UNIT = "%"
LAYER = "planner"
MOVES = "conf_per_s"


def read(ctx: dict):
    return program.counter_share(ctx, "trunk.positions_valid",
                                 "trunk.positions_run")
