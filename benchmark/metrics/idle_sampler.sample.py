"""idle_sampler.sample: Idle seconds of the traced request's card put
down to the program's ``sample.*`` spans (the request, the plan, a
batch, a step, the draws, the update, the tokens' copy to the host:
``benchmark/program.py``), over the traced window's seconds."""

from benchmark import program

UNIT = "%"
LAYER = "sampler loop"
MOVES = "conf_per_s"


def read(ctx: dict):
    return program.idle_share(ctx, program.sampling)
