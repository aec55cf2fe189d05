"""The yardstick's arithmetic: the work of a request or a training step,
counted from its shapes, and the chip's published peaks.

Counted from what the request asks for, never from how the program lays
it out: a request of ``samples`` conformations of a chain of ``residues``
needs, per sample, ``forwards`` trunk forwards over residues + 2 tokens and
one decoder pass over them, whatever the batch plan, the packing or the
surplus rows.  A product of an (n, k) by a (k, m) matrix is 2 n k m FLOPs;
attention over n tokens is 4 n^2 d a layer (the scores and the weighted
sum over the tokens' own keys).  Embedding lookups, norms, activations and
the sampler's own work count nothing.  Of the heads, only the structure
head that the samplers and the loss read is counted.  A training step is
3x the forward of its real tokens (forward, and the backward's two
products a product): remat's recompute is not work the step needs.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense: bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def stack_params(d: int, hidden: int, n_layers: int) -> int:
    """Product weights a token goes through in the blocks: QKV, output,
    SwiGLU up (2 x hidden) and down."""
    return n_layers * (3 * d * d + d * d + 2 * d * hidden + hidden * d)


def trunk_forward_flops(t: dict, n: int) -> float:
    """One trunk forward over one sequence of ``n`` tokens, with the
    structure head (``configs/*.json``'s ``trunk``)."""
    d = t["d_model"]
    head_out = 4096 if t["head"] == "esm3" else t["n_structure_heads"]
    per_token = stack_params(d, t["ffn_hidden"], t["n_layers"]) \
        + d * d + d * head_out
    return 2.0 * n * per_token + 4.0 * t["n_layers"] * n * n * d


def sigma_flops(t: dict) -> float:
    """The sigma embedder for one sequence (one time)."""
    d = t["d_model"]
    return 2.0 * (t["sigma_frequency_size"] * d + d * d)


def decoder_flops(dec: dict, n: int) -> float:
    """One VQ decoder pass over ``n`` tokens: the stack, the 6D rotation
    head and the pLDDT head."""
    d = dec["d_model"]
    per_token = stack_params(d, dec["ffn_hidden"], dec["n_layers"]) \
        + (d * d + 9 * d) + (d * d + dec["plddt_bins"] * d)
    return 2.0 * n * per_token + 4.0 * dec["n_layers"] * n * n * d


def sample_request_flops(cfg: dict, residues: int, samples: int,
                         forwards: int, timed: bool) -> float:
    """A request: per sample ``forwards`` trunk forwards (and sigma
    embeddings when the sampler is ``timed``) and one decode."""
    n = residues + 2
    per_forward = trunk_forward_flops(cfg["trunk"], n)
    if timed:
        per_forward += sigma_flops(cfg["trunk"])
    return samples * (forwards * per_forward
                      + decoder_flops(cfg["decoder"], n))


def train_step_flops(cfg: dict, segment_lengths) -> float:
    """A packed step: forward and backward of every real segment (one
    sigma embedding a segment), remat's recompute left out."""
    t = cfg["trunk"]
    fwd = sum(trunk_forward_flops(t, int(n)) + sigma_flops(t)
              for n in segment_lengths)
    return 3.0 * fwd


def flash_call_bound_s(B: int, L: int, H: int, Dh: int, lengths) -> float:
    """Least time of one attention call on the chip: the larger of its
    FLOPs (every query against its row's valid keys, 4 L l Dh a head) over
    the bf16 peak and its bytes (q, k, v read once, o written once, bf16;
    the int32 lengths) over the HBM bandwidth."""
    valid = [L] * B if lengths is None else [int(n) for n in lengths]
    flops = sum(4.0 * L * n * Dh * H for n in valid)
    nbytes = 4 * B * L * H * Dh * 2 + 4 * B
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
