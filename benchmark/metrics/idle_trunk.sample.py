"""idle_trunk.sample: Idle seconds of the traced request's card put down
to the program's ``trunk.forward`` spans (the innermost program span open
on the host when each gap began, ``benchmark/program.py``), over the
traced window's seconds."""

from benchmark import program

UNIT = "%"
LAYER = "model step"
MOVES = "conf_per_s"


def read(ctx: dict):
    return program.idle_share(ctx, lambda n: n == "trunk.forward")
