"""decode_share.sample: Host seconds in the VQ decode (``EnsembleSampler.decode_ensemble``) and
the multi-MODEL PDB writer, over the window's seconds."""

UNIT = "%"
LAYER = "decoder and writer"
MOVES = "conf_per_s"


def read(ctx: dict):
    s = ctx["spans"]
    if "decode" not in s:
        return None
    return 100.0 * (s["decode"] + s.get("pdb", 0.0)) / ctx["window_s"]
