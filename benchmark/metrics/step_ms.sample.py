"""step_ms.sample: Host milliseconds of the sampling calls (``EnsembleSampler.ddpm_ensemble``
or ``gibbs_ensemble``, each ending when its tokens reach the host) over
the window, per trunk forward counted by the benchmark's forward hook."""

UNIT = "ms"
LAYER = "sampler loop"
MOVES = "conf_per_s"


def read(ctx: dict):
    n = ctx.get("forwards")
    s = ctx["spans"].get("sample")
    if not n or s is None:
        return None
    return 1e3 * s / n
