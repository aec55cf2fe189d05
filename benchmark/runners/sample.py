"""Sampling cells: one client sends requests back to back, each of
``samples`` conformations of one chain through ``EnsembleSampler`` (ddpm or
gibbs, the CLI's plan), the VQ decode and the multi-MODEL PDB writer, as
``esmdiff-torch-sample`` runs a target.

Set-up: the port's modules built on the card and filled by its own
converters from seeded weights in the published layout
(``benchmark/weights.py``), matmul weights cast to bf16 as a runtime
serves them, then one short request at the cell's shapes (``warmup_steps``
sampler steps over one batch, its decode and its PDB).  Each phase's
seconds are printed on one line.

The window runs requests until the one that crosses ``seconds`` ends.  One
request drawn from the seed is watched: every trunk forward's input tokens,
and the logits of ``capture.forwards`` forwards drawn from the seed and of
each batch's last forward.
After the window the program is freed and the float32 reference
(``benchmark/reference``) judges what it produced:

  trunk_stage_err  two of the watched forwards stage by stage, each stage
                   against the reference's same stage computed from the
                   program's own input to it: the embedding, every block's
                   attention and SwiGLU outputs and residual sums, the
                   final norm and the structure head; the largest
                   |x - x_ref| / |x_ref| over the valid positions;
  update_mismatch  positions where the sampler's next tokens differ from
                   the reference step given the program's own logits and
                   the draws worked out again from the request's seed;
  coord_rmsd_A     the decoded backbone (N, CA, C) of ``capture.rows``
                   samples drawn from the seed against the reference's
                   decode of the same tokens: the mean of the samples'
                   RMSDs, in A;
  coord_rows_over  how many of those samples lie more than
                   ``capture.row_rmsd_A`` off: a fault in one slot, which
                   the mean dilutes, still counts one.

``memory_peak_bytes`` is ``max_memory_allocated`` over each request of the
window, set-up left out, less what the watch holds on the card then: the
program's own peak.

With ``--trace 1`` the per-layer numbers come from the same window, and
one more request runs under the profiler for the device's.
"""

from __future__ import annotations

import gc
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import counts, generator, harness, weights
from benchmark.reference import model as R
from benchmark.reference import sampler as RS


def program_configs(cfg: dict):
    from esmdiff_tpu_torch.models.esm3 import ESM3Config
    from esmdiff_tpu_torch.models.vqvae import DecoderConfig

    t, d = cfg["trunk"], cfg["decoder"]
    tcfg = ESM3Config(d_model=t["d_model"], n_heads=t["n_heads"],
                      v_heads=t["v_heads"], n_layers=t["n_layers"],
                      n_layers_geom=t["n_layers_geom"], head_type=t["head"],
                      n_structure_heads=t["n_structure_heads"],
                      dtype=t["dtype"])
    dcfg = DecoderConfig(d_model=d["d_model"], n_heads=d["n_heads"],
                         n_layers=d["n_layers"],
                         plddt_bins=d["plddt_bins"],
                         trans_scale=d["trans_scale"], dtype=d["dtype"])
    if (tcfg.ffn_hidden, dcfg.stack_config().ffn_hidden) != (
            t["ffn_hidden"], d["ffn_hidden"]):
        raise ValueError("the port's SwiGLU widths differ from the "
                         "configuration's ffn_hidden")
    return tcfg, dcfg


def weight_shapes(cfg: dict, timed: bool):
    trunk = weights.trunk_shapes(cfg["trunk"])
    if timed:
        trunk.update(weights.sigma_shapes(cfg["trunk"]))
    return trunk, weights.decoder_shapes(cfg["decoder"])


def build_runtime(cfg: dict, timed: bool, wseeds, device, quant="none"):
    """The port's runtime filled from the seeded published-layout weights
    by its converters; ``quant="int8"`` quantizes trunk and decoder (the
    program's own lower-precision path: the control)."""
    from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
    from esmdiff_tpu_torch.convert import torch_ckpt
    from esmdiff_tpu_torch.models.esm3 import ESM3
    from esmdiff_tpu_torch.models.vqvae import StructureTokenDecoder
    from esmdiff_tpu_torch.nn.layers import (TimestepEmbedder,
                                             cast_matmul_weights)

    tcfg, dcfg = program_configs(cfg)
    t_shapes, d_shapes = weight_shapes(cfg, timed)
    with torch.device(device):
        trunk = ESM3(tcfg)
        decoder = StructureTokenDecoder(dcfg)
        sigma = (TimestepEmbedder(tcfg.d_model, dtype=tcfg.torch_dtype)
                 if timed else None)
    W = weights.make(t_shapes, wseeds[0], device)
    if timed:
        torch_ckpt.convert_mdlm(trunk, sigma, {
            (k if k.startswith("sigma_embedder.") else "net." + k): v
            for k, v in W.items()})
    else:
        torch_ckpt.convert_trunk(trunk, W)
    del W
    W = weights.make(d_shapes, wseeds[1], device)
    torch_ckpt.convert_vqvae_decoder(decoder, W)
    del W
    rt = ESM3Runtime(trunk, decoder, sigma, device=device)
    if quant != "none":
        rt = rt.quantize(quant, include_decoder=True)
    for m in (rt.trunk, rt.decoder, rt.sigma_embedder):
        if m is not None:
            cast_matmul_weights(m)
    return rt


class Watch:
    """The watched request: every forward's input tokens; the logits of the
    forwards in ``keep``; and of those in ``deep``, every stage of the
    trunk's own state (the embedding, each block's attention and SwiGLU
    inputs and outputs, the final norm, the structure head), at the
    trunk's layout."""

    def __init__(self, trunk, keep, deep, L):
        self.trunk, self.L = trunk, L
        self.keep, self.deep = set(keep) | set(deep), set(deep)
        self.tokens, self.logits, self.stages = [], {}, {}
        self._handles, self._seen = [], []

    def start(self, args, kwargs):
        if len(self.tokens) not in self.deep:
            return
        t = self.trunk
        sites = [("embed", t.encoder), ("norm", t.transformer.norm),
                 ("head", t.output_heads.structure_head)]
        for i, blk in enumerate(t.transformer.blocks):
            sites += [(f"attn.{i}", blk.attn), (f"ffn.{i}", blk.ffn)]
        for name, mod in sites:
            self._handles.append(mod.register_forward_hook(
                lambda m, a, o, name=name: self._seen.append(
                    (name, a[0].detach().clone(), o.detach().clone()))))

    def __call__(self, args, kwargs, output):
        k = len(self.tokens)
        x = kwargs["structure_tokens"]
        self.tokens.append(x.reshape(-1, self.L).clone())
        if k in self.keep:
            z = output.structure_logits
            self.logits[k] = z.reshape(-1, self.L, z.shape[-1]).float().clone()
        if self._handles:
            for h in self._handles:
                h.remove()
            self.stages[k] = {name: (i, o) for name, i, o in self._seen}
            self._handles, self._seen = [], []

    def nbytes(self) -> int:
        """Bytes the watch holds on the card, as the caching allocator
        counts them (blocks of 512)."""
        held = list(self.tokens) + list(self.logits.values()) + [
            t for st in self.stages.values() for pair in st.values()
            for t in pair] + [t for _, i, o in self._seen for t in (i, o)]
        return sum(-(-t.untyped_storage().nbytes() // 512) * 512
                   for t in held if t.is_cuda)


def run(job: dict) -> dict:
    with tempfile.TemporaryDirectory(prefix="bench_pdb_") as out_dir:
        return _run(job, Path(out_dir))


def _run(job: dict, out_dir: Path) -> dict:
    cfg, traffic, device = job["config"], job["traffic"], job["device"]
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    s_weights, s_traffic, s_watch = harness.seeds(job["seed"], 3)
    wseeds = harness.seeds(s_weights, 2)
    samples = traffic["samples"]
    timed = traffic["mode"] == "ddpm"
    steps = traffic["steps"]
    n_iters = steps + 1 if timed else steps
    batch, n_batches = RS.single_plan(samples)

    from esmdiff_tpu_torch.api.generation import (EnsembleSampler,
                                                  GenerationConfig)
    from esmdiff_tpu_torch.core import protein as protein_io

    phase = harness.Phases(job["t_start"], sync)
    phase("imports")
    runtime = build_runtime(cfg, timed, wseeds, device,
                            quant=job.get("quant", "none"))
    phase("weights")
    sampler = EnsembleSampler(runtime, plan_policy=traffic["plan"])
    hooks = harness.TrunkHooks(runtime.trunk)
    spans = harness.Spans()

    def request(req, n, n_steps, path):
        seq = req["sequence"]
        with spans.span("sample"):
            if timed:
                toks = sampler.ddpm_ensemble(seq, n, num_steps=n_steps,
                                             seed=req["seed"])
            else:
                toks = sampler.gibbs_ensemble(
                    seq, n, seed=req["seed"], config=GenerationConfig(
                        num_steps=n_steps, temperature=traffic["temperature"],
                        top_p=traffic["top_p"]))
        with spans.span("decode"):
            prots = sampler.decode_ensemble(seq, toks,
                                            traffic["decode_batch"])
        with spans.span("pdb"):
            protein_io.ensemble_to_pdb_file(
                [p.to_protein() for p in prots], path)
        ok = (len(prots) == n and all(
            np.isfinite(p.coordinates[:, :3]).all() for p in prots))
        return toks, prots, ok

    reqs = generator.requests(traffic, s_traffic, 4096)
    request(reqs[-1], batch, traffic["warmup_steps"], out_dir / "w.pdb")
    phase("warm-up request")
    setup_s = time.monotonic() - job["t_start"]
    print(phase.line(), flush=True)

    rng = np.random.default_rng(s_watch)
    cap = traffic["capture"]
    watch_req = int(rng.integers(cap["requests"]))
    L = bucket(reqs[watch_req]["sequence"])
    # forwards drawn one from each of ``forwards`` runs of the request's,
    # and every batch's last: the one that makes its final tokens; the
    # stages of ``deep`` of them
    keep = [int(rng.choice(part)) for part in np.array_split(
        np.arange(n_batches * n_iters), cap["forwards"])]
    watch = Watch(runtime.trunk, keep + [n_iters * (b + 1) - 1
                                         for b in range(n_batches)],
                  rng.choice(keep, cap["deep"], replace=False).tolist(), L)
    rows = rng.choice(samples, cap["rows"], replace=False)
    spans = harness.Spans()
    forwards0 = hooks.forwards
    attempted = failed = completed = 0
    work = 0.0
    watched = peak = None
    t0 = time.perf_counter()
    while True:
        req = reqs[attempted]
        t_req = time.perf_counter()
        hooks.on_call = watch if attempted == watch_req else None
        hooks.on_start = watch.start if attempted == watch_req else None
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        try:
            toks, prots, ok = request(req, samples, steps, out_dir / "r.pdb")
        except Exception as e:  # a request that raises is counted failed
            print(f"request {attempted} raised: {e!r}", flush=True)
            ok = False
        hooks.on_call = hooks.on_start = None
        if cuda:
            # the watch's copies are the benchmark's, not the program's;
            # in the watched request they grow, so the difference there
            # is at most the program's peak
            peak = max(peak or 0, torch.cuda.max_memory_allocated(device)
                       - watch.nbytes())
        if attempted == watch_req and ok:
            watched = (req, toks, [prots[int(j)].coordinates[:, :3]
                                   for j in rows])
        print(f"request {attempted}: {len(req['sequence'])} residues, "
              f"{time.perf_counter() - t_req:.3f} s", flush=True)
        attempted += 1
        failed += not ok
        if ok:
            completed += samples
            work += counts.sample_request_flops(
                cfg, len(req["sequence"]), samples, n_iters, timed)
        if (time.perf_counter() - t0 >= job["seconds"]
                and attempted > watch_req):
            break
    window_s = time.perf_counter() - t0

    result = {"attempted": attempted, "failed": failed}
    if job["trace"]:
        ctx = {"window_s": window_s, "spans": dict(spans.seconds),
               "forwards": hooks.forwards - forwards0, "work_flops": work,
               "peak_bytes": peak, "trace": None}
        if cuda:
            ctx["trace"], ctx["flash_bound_s"] = traced_request(
                request, reqs[attempted], samples, steps, out_dir, sync)
            result["breakdown"] = {"device_ops": ctx["trace"].top_ops(),
                                   "idle_gaps": ctx["trace"].idle_gaps()}
            result["trace_device"] = {"busy_s": ctx["trace"].busy_s,
                                      "window_s": ctx["trace"].window_s}
        result["metrics"] = harness.read_metrics(job["per_layer"], ctx)
    else:
        result["metrics"] = {
            "conf_per_s": {"value": completed / window_s, "unit": "conf/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    result["peak_bytes"] = peak
    hooks.remove()
    del sampler, runtime, hooks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # no watched request completed: nothing to compare, so not correct
    result["numbers"] = {} if watched is None else check(
        cfg, traffic, wseeds, watch, watched, rows, n_iters, batch, device)
    result["rows_rmsd_A"] = result["numbers"].pop("rows_rmsd_A", None)
    return result


def bucket(sequence: str) -> int:
    return -(-(len(sequence) + 2) // 32) * 32


def traced_request(request, req, samples, steps, out_dir, sync):
    """One request under the profiler, every flash call's least time
    counted from its shapes and lengths."""
    from esmdiff_tpu_torch.ops import flash_attention as flash_ops

    calls = []
    plain = flash_ops.flash_attention

    def counted(q, k, v, lengths=None):
        # a reference, read on the host once the trace has closed
        calls.append((tuple(q.shape), lengths))
        return plain(q, k, v, lengths)

    flash_ops.flash_attention = counted
    try:
        with torch.no_grad():
            trace, _ = harness.traced(
                lambda: request(req, samples, steps, out_dir / "t.pdb"),
                sync)
    finally:
        flash_ops.flash_attention = plain
    bound = sum(counts.flash_call_bound_s(
        B, L, H, Dh, None if n is None else n.cpu().tolist())
        for (B, L, H, Dh), n in calls)
    return trace, bound


@torch.no_grad()
def check(cfg, traffic, wseeds, watch, watched, rows, n_iters, batch,
          device) -> dict:
    """The reference's judgement of the watched request (module
    docstring)."""
    R.set_precision()
    req, final, coords = watched
    timed = traffic["mode"] == "ddpm"
    steps, samples = traffic["steps"], traffic["samples"]
    n = len(req["sequence"]) + 2
    L = watch.L
    t_shapes, d_shapes = weight_shapes(cfg, timed)
    W = weights.make(t_shapes, wseeds[0], device)
    numbers = {"update_mismatch": 0}
    if len(watch.tokens) != n_iters * -(-samples // batch):
        numbers["update_mismatch"] = None
    stage_errors = {}
    for k, stages in sorted(watch.stages.items()):
        for name, err in trunk_stages(W, cfg["trunk"], req, k, stages, watch,
                                      n_iters, steps, timed).items():
            stage_errors[name] = max(stage_errors.get(name, 0.0), err)
    if stage_errors:
        numbers["trunk_stage_err"] = max(stage_errors.values())
        for kind in ("embed", "attn", "ffn", "residual", "norm", "head"):
            numbers[f"stage.{kind}"] = max(
                (v for n_, v in stage_errors.items()
                 if n_.split(".")[0] == kind), default=None)
    for k, z_prog in sorted(watch.logits.items()):
        if numbers["update_mismatch"] is None:
            break
        b, i = divmod(k, n_iters)
        x = watch.tokens[k].to(device)
        ids = RS.batch_rows(samples, batch, b)
        z_prog = z_prog.to(device)
        if timed:
            nxt = RS.ddpm_update(x, z_prog, i, steps, RS.ddpm_draws(
                req["seed"], ids, L, z_prog.shape[-1], i, device)
                if i < steps else None)
        else:
            dmask = torch.zeros(x.shape, dtype=torch.bool, device=device)
            dmask[:, 1:n - 1] = True
            nxt = RS.gibbs_update(
                x, z_prog, i, steps, dmask, dmask.sum(-1), RS.gibbs_uniforms(
                    req["seed"], ids, L, z_prog.shape[-1], i, device),
                traffic["temperature"], traffic["top_p"])
        if i + 1 < n_iters:
            numbers["update_mismatch"] += int(
                (nxt != watch.tokens[k + 1].to(device)).sum())
        else:                      # the last step: the returned tokens
            first = {int(j): r for r, j in reversed(list(enumerate(ids)))}
            got = torch.as_tensor(final[sorted(first)], device=device)
            want = nxt[[first[j] for j in sorted(first)], 1:n - 1]
            numbers["update_mismatch"] += int((want != got.long()).sum())
    del W
    W = weights.make(d_shapes, wseeds[1], device)
    toks = torch.as_tensor(final[rows].astype(np.int64), device=device)
    toks = torch.cat([torch.full((len(rows), 1), R.STRUCT_BOS, device=device),
                      toks, torch.full((len(rows), 1), R.STRUCT_EOS,
                                       device=device)], dim=1)
    bb = R.decode_backbone(W, cfg["decoder"], toks)[:, 1:n - 1]
    got = torch.as_tensor(np.stack(coords), device=device, dtype=torch.float32)
    rmsd = ((got - bb) ** 2).sum(-1).mean(dim=(1, 2)).sqrt()
    numbers["coord_rmsd_A"] = float(rmsd.mean())
    numbers["coord_rows_over"] = int(
        (rmsd > traffic["capture"]["row_rmsd_A"]).sum())
    numbers["rows_rmsd_A"] = rmsd.tolist()
    return numbers


def trunk_stages(W, t, req, k, stages, watch, n_iters, steps, timed):
    """Each stage of one trunk forward against the reference's same stage
    computed from the program's own input to it: {stage: relative error
    over the valid positions}.  Residual stages compare the input the next
    stage received with the reference's sum of the previous input and the
    stage's output over the residual scale."""
    prec = R.Precision()
    enc = stages["embed"][1]
    dev = enc.device
    rows, T = enc.shape[:2]
    L, n = watch.L, len(req["sequence"]) + 2
    pack = T // L
    in_seg = torch.arange(T, device=dev) % L
    valid = (in_seg < n).expand(rows, T)
    seq = torch.full((L,), R.SEQ_PAD, dtype=torch.long, device=dev)
    seq[:n] = torch.tensor(R.encode_sequence(req["sequence"]), device=dev)
    seq = seq.repeat(pack).expand(rows, T)
    tokens = watch.tokens[k].to(dev).reshape(rows, T)
    positions = in_seg.expand(rows, T)
    if pack == 1:
        allowed = R.key_mask(torch.full((rows,), n, device=dev), T)
    else:
        seg = torch.where(valid, torch.arange(T, device=dev) // L, -1)
        allowed = R.segment_mask(seg)
    cos, sin = R.rotary(positions, t["d_model"] // t["n_heads"])
    scale = math.sqrt(t["n_layers"] / 36.0)

    def err(got, want):
        d = (got.float() - want)[valid]
        return float(d.norm() / want[valid].norm())

    out = {"embed": err(enc, R.embed(W, seq, tokens, prec))}
    x = enc.float()
    if timed:
        ts = torch.linspace(1.0, 1e-5, steps + 1, dtype=torch.float32)
        sig = RS.loglinear_sigma(ts[k % n_iters].to(dev).expand(1))
        x = x + R.sigma_embed(W, sig, prec)[:, None, :]
    prev = ("residual.sigma", x)
    for i in range(t["n_layers"]):
        p = f"transformer.blocks.{i}"
        for kind, fn in (("attn", lambda h: R.attn_sub(
                W, p, h, cos, sin, allowed, t["n_heads"], prec)),
                         ("ffn", lambda h: R.ffn_sub(W, p, h, prec))):
            h, o = stages[f"{kind}.{i}"]
            out[prev[0]] = err(h, prev[1])
            out[f"{kind}.{i}"] = err(o, fn(h.float()))
            prev = (f"residual.{kind}.{i}", h.float() + o.float() / scale)
    h, o = stages["norm"]
    out[prev[0]] = err(h, prev[1])
    out["norm"] = err(o, R.layer_norm(h.float(), W["transformer.norm.weight"]))
    h, o = stages["head"]
    out["head"] = err(o, R.head(W, "output_heads.structure_head", h.float(),
                                prec))
    return out
