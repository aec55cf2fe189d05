"""block_forward_ms.sample: Host milliseconds of the traced request's
``block.prefill``, ``block.step`` and ``block.commit`` spans
(``diffusion/block.py``: a step with its draw and update), over its
``block.forwards``."""

from benchmark import counts_sdar, program

UNIT = "ms"
LAYER = "sampler loop"
MOVES = "conf_per_s"


def read(ctx: dict):
    found = program.spans(ctx)
    if found is None:
        return None
    n = counts_sdar.traced_counts(found).get("block.forwards")
    ns = sum(s["end_ns"] - s["start_ns"] for name, _, _, s in found
             if name in ("block.prefill", "block.step", "block.commit"))
    if not n or not ns:
        return None
    return 1e-6 * ns / n
