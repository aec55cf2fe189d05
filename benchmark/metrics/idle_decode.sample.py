"""idle_decode.sample: Idle seconds of the traced request's card put down
to the program's ``decode``, ``decode.device``, ``decode.host`` and
``pdb.write`` spans (``benchmark/program.py``), over the traced window's
seconds."""

from benchmark import program

UNIT = "%"
LAYER = "decoder and writer"
MOVES = "conf_per_s"


def read(ctx: dict):
    return program.idle_share(ctx, program.decoding)
