"""Block-diffusion sampling cells (SDAR): one client sends requests back to
back, each of ``samples`` conformations of one chain through
``EnsembleSampler.block_ensemble`` (the planner's ``plan`` with
``max_batch``), the VQ decode and the multi-MODEL PDB writer, as
``esmdiff-torch-sample --mode block`` runs a target.

Set-up: the port's SDAR model and VQ decoder built on the card and filled
by the port's converters from seeded weights in the published layout,
one part at a time (``benchmark/weights_sdar.py``: never the whole model
in float32 beside it), then one short request (the first residues of a
chain, all ``samples`` rows).  Each phase's seconds are printed on one
line.

The window runs requests until the one that crosses ``seconds`` ends.  One
request drawn from the seed is watched, in its first batch, as it runs:
its steps and commits are the same CUDA-graph replays as in any request,
and the watch reads what each replay left (``diffusion/block.py``'s
static buffers) for ``capture.rows`` rows drawn from the seed: every
forward's input tokens and every layer's expert sets, every step's
logits over the codes and its tokens after the update.  Before
``capture.deep`` step forwards drawn from the seed, the same forward runs
once more eagerly (a side run: it writes nothing the request reads), where
module hooks read every layer's stages: the layer's input, its attention
output and the cache it read, the MoE's input and output, for the drawn
rows; the MoE's input, router logits and expert sets for every row.  The
prefill, eager in every request, is read by the same hooks.  After the
window the program is freed and the float32 reference
(``benchmark/reference/sdar.py``, one layer's weights at a time) judges
what it produced:

  stage_err        each deep forward's layers stage by stage, each stage
                   from the program's own input to it (the eager side
                   run's): the attention (with its input norm) over the
                   program's cache, the MoE (with its input norm), the two
                   residual sums, the final norm and head; the largest
                   |x - x_ref| / |x_ref|;
  route_mismatch   tokens of the deep forwards' MoE layers (every row)
                   whose expert set in the replay differs from the
                   reference's top-k of the program's own router input,
                   other than by a tie;
  route_ties       (reported, no limit) those that differ only in experts
                   whose router logits lie within ``capture.route_margin``
                   of the reference's k-th largest;
  route_logit_err  (reported, no limit) the largest |z - z_ref| of the
                   program's bf16 router logits, the bf16 rounding the
                   margin is set from;
  logits_rel_err   ``capture.forwards`` step forwards drawn from the seed:
                   the replay's logits through the cache against the
                   reference's cacheless block-causal forward over the
                   same tokens (the prompt, the committed blocks, the
                   block as it stood) with the replays' expert sets: the
                   largest relative L2 error of a position over the 4,096
                   structure codes;
  update_mismatch  positions where a replayed step's tokens after its
                   update differ from the reference's update of its tokens
                   before, given the replay's logits and the draws worked
                   out again from the request's seed (every step of the
                   batch); and where the returned tokens differ from the
                   blocks as committed;
  coord_rmsd_A     the decoded backbone (N, CA, C) of ``capture.rows_rmsd``
  coord_rows_over  samples against the reference's decode of the same
                   tokens, as the ddpm cells compute them.

``memory_peak_bytes`` is ``max_memory_allocated`` over each request of the
window, set-up left out, less what the watch holds on the card then.  With
``--trace 1`` the per-layer numbers come from the same window, and one
more request, replayed as every other, runs under the profiler for the
device's.  Before it, one request of the same chain's first
``eager_residues`` residues runs eagerly under the profiler (``eager``:
the graphs' kernels, which replays launch outside the model's ``moe.*``
spans, inside them): ``moe_share.sample`` and ``moe_roofline.sample``
read it.

The limits' controls (``job["controls"]``, each read beside the
program's numbers; ``job["control"]``, one read in the program's
place): "int8" the W8A8 expert products of the reference in the
program's place for the MoE stage (``stage_err``), "fp8" the reference in
float8 in the program's place (``logits_rel_err``), "fp8_router" its
router in float8 (``route_mismatch``); "top7" runs the program routing 7
experts a token.
"""

from __future__ import annotations

import functools
import gc
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import counts_sdar, generator, harness, weights, weights_sdar
from benchmark.reference import model as R
from benchmark.reference import sdar as RS

MASK = 4096


REFERENCE_CONTROLS = ("int8", "fp8", "fp8_router")
# route margins the float8 router control is also read at
MARGINS = (1 / 256, 1 / 128, 1 / 64, 1 / 32, 1 / 16)
# the number each control is read on
CONTROL_OF = {"int8": "stage_err", "fp8": "logits_rel_err",
              "fp8_router": "route_mismatch"}


def program_config(cfg: dict, control: str = "none"):
    from esmdiff_tpu_torch.models.sdar import SDARConfig

    kw = {"num_experts_per_tok": 7} if control == "top7" else {}
    return SDARConfig.from_hf(cfg, dtype=cfg["dtype"], **kw)


def decoder_config(dec: dict):
    from esmdiff_tpu_torch.models.vqvae import DecoderConfig

    dcfg = DecoderConfig(d_model=dec["d_model"], n_heads=dec["n_heads"],
                         n_layers=dec["n_layers"],
                         plddt_bins=dec["plddt_bins"],
                         trans_scale=dec["trans_scale"], dtype=dec["dtype"])
    if dcfg.stack_config().ffn_hidden != dec["ffn_hidden"]:
        raise ValueError("the port's decoder SwiGLU width differs from the "
                         "configuration's ffn_hidden")
    return dcfg


def build_runtime(cfg: dict, s_model: int, s_decoder: int, device,
                  control: str = "none"):
    """The SDAR model and VQ decoder, filled part by part from the seeded
    published-layout weights by the port's converters."""
    from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
    from esmdiff_tpu_torch.convert import sdar as conv
    from esmdiff_tpu_torch.convert import torch_ckpt
    from esmdiff_tpu_torch.models.sdar import SDAR
    from esmdiff_tpu_torch.models.vqvae import StructureTokenDecoder
    from esmdiff_tpu_torch.nn.layers import cast_matmul_weights

    with torch.device(device):
        model = SDAR(program_config(cfg, control))
        decoder = StructureTokenDecoder(decoder_config(cfg["decoder"]))
    conv.load(model, weights_sdar.make_top(cfg, s_model, device), layers=[])
    for i in range(cfg["num_hidden_layers"]):
        conv.load(model, weights_sdar.make_layer(cfg, i, s_model, device),
                  layers=[i], top=False)
    W = weights.make(weights.decoder_shapes(cfg["decoder"]), s_decoder,
                     device)
    torch_ckpt.convert_vqvae_decoder(decoder, W)
    del W
    cast_matmul_weights(decoder)
    return ESM3Runtime(model, decoder, None, device=device)


def schedule(residues: int, block: int, steps: int) -> list[tuple]:
    """A batch's forwards: ("prefill", 0, P), then for each block its
    ("step", start, width, step index, quota)s and ("commit", start,
    width)."""
    P = residues + 2
    out, k = [("prefill", 0, P)], 0
    for b0 in range(0, residues, block):
        m = min(block, residues - b0)
        n_steps = min(steps, m)
        for s in range(n_steps):
            out.append(("step", P + b0, m, k,
                        m // n_steps + (s < m % n_steps)))
            k += 1
        out.append(("commit", P + b0, m))
    return out


class Watch:
    """The watched request's first batch (module docstring).  ``wrap``
    puts it around the ``run`` of the sampler's held ``BlockForwards``
    for the request; module hooks read the prefill and the deep side
    runs, and nothing else."""

    def __init__(self, model, plan, rows, keep, deep):
        self.model, self.plan = model, plan
        self.rows = torch.as_tensor(rows)
        self.keep, self.deep = set(keep), set(deep)
        self.f = 0                  # the forward running: the prefill is 0
        self.hooked = True          # the prefill, then the deep side runs
        self.wrapped = []
        # by forward: the drawn rows' tokens before and after it, expert
        # ids (layers, rows, n, k) and the step's logits; every row's
        # expert ids at the deep forwards
        self.tokens, self.after, self.routes, self.logits = {}, {}, {}, {}
        self.all_routes = {}
        self.stages = {}          # forward -> layer -> {name: tensor}
        self.handles = [
            model.embed_tokens.register_forward_pre_hook(self._start),
            model.lm_head.register_forward_hook(
                lambda m, a, o: self._keep("top", "logits", o[..., :MASK],
                                           rows=True)),
            model.norm.register_forward_hook(
                lambda m, a, o: self._keep("top", "norm_in", a[0],
                                           rows=True))]
        for i, layer in enumerate(model.layers):
            self.handles += [
                layer.register_forward_pre_hook(
                    lambda m, a, i=i: self._keep(i, "x", a[0], rows=True)),
                layer.register_forward_hook(
                    lambda m, a, o, i=i: self._keep(i, "out", o, rows=True)),
                layer.self_attn.register_forward_hook(
                    lambda m, a, o, i=i: self._attn(i, a, o)),
                layer.post_attention_layernorm.register_forward_hook(
                    lambda m, a, o, i=i: self._keep(i, "h", a[0])),
                layer.mlp.register_forward_hook(
                    lambda m, a, o, i=i: self._keep(i, "moe", o)),
                layer.mlp.gate.register_forward_hook(
                    lambda m, a, o, i=i: self._route(i, m, a[0], o[1]))]

    def wrap(self, held: dict) -> None:
        """Watch the steps and commits of ``held``'s ``BlockForwards``."""
        for fw in held.values():
            fw.run = functools.partial(self._run, fw, fw.run)
            self.wrapped.append(fw)

    def _run(self, fw, run, kind, graphs=True):
        self.hooked = False
        self.f += 1
        f = self.f
        if f >= len(self.plan):                 # a later batch
            return run(kind, graphs)
        if kind != self.plan[f][0]:
            raise RuntimeError(f"forward {f}: the sampler ran a {kind}, "
                               f"the plan has a {self.plan[f][0]}")
        rows = self.rows = self.rows.to(fw.x.device)
        self.tokens[f] = fw.x[rows]
        if f in self.deep:                      # the eager side run
            self.shape = tuple(fw.x.shape)
            self.hooked = True
            self.model.block(fw.x, fw.start, fw.cache, valid=fw.valid)
            self.hooked = False
        run(kind, graphs)
        self.routes[f] = fw.routes[:, rows]
        if kind == "step":
            self.after[f] = fw.x[rows]
            self.logits[f] = fw.logits[rows]
            if f in self.deep:
                self.all_routes[f] = fw.routes.clone()

    def _start(self, m, args):
        if self.hooked and self.f == 0:
            x = args[0]
            self.tokens[0] = x[self.rows.to(x.device)].clone()
            self.routes[0] = [None] * len(self.model.layers)

    def _keep(self, i, name, t, rows=False):
        if self.hooked and self.f in self.deep:
            t = t[self.rows.to(t.device)] if rows else t
            self.stages.setdefault(self.f, {}).setdefault(i, {})[name] = \
                t.detach().clone()

    def _attn(self, i, args, out):
        if not (self.hooked and self.f in self.deep):
            return
        fw, start = args[1], int(args[1].start)
        rows = self.rows.to(out.device)
        st = self.stages.setdefault(self.f, {}).setdefault(i, {})
        st["attn"] = out[rows].clone()
        st["k_before"] = fw.cache.k[i][rows, :, :start].transpose(
            1, 2).clone()
        st["v_before"] = fw.cache.v[i][rows, :, :start].transpose(
            1, 2).clone()

    def _route(self, i, gate, x, ids):
        if not self.hooked:
            return
        if self.f == 0:                         # the prefill
            ids = ids.view(-1, self.tokens[0].shape[1], ids.shape[-1])
            self.routes[0][i] = ids[self.rows.to(ids.device)].clone()
        elif self.f in self.deep:
            st = self.stages[self.f][i]
            st["ids"] = ids.view(*self.shape, -1).clone()
            st["z"] = torch.nn.functional.linear(x, gate.weight).view(
                *self.shape, -1)

    def remove(self):
        for h in self.handles:
            h.remove()
        for fw in self.wrapped:
            del fw.run
        self.handles, self.wrapped, self.model = [], [], None
        if isinstance(self.routes.get(0), list):
            self.routes[0] = torch.stack(self.routes[0])

    def nbytes(self) -> int:
        held = [t for d in (self.tokens, self.after, self.routes,
                            self.logits, self.all_routes)
                for t in d.values() if torch.is_tensor(t)] + [
            t for f in self.stages.values() for st in f.values()
            for t in st.values()]
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
    s_model, s_decoder = harness.seeds(s_weights, 2)
    samples = traffic["samples"]
    control = job.get("control", "none")

    from esmdiff_tpu_torch.api.generation import EnsembleSampler
    from esmdiff_tpu_torch.core import protein as protein_io

    phase = harness.Phases(job["t_start"], sync)
    phase("imports")
    runtime = build_runtime(cfg, s_model, s_decoder, device, control)
    phase("weights")
    sampler = EnsembleSampler(runtime, plan_policy=traffic["plan"])
    spans = harness.Spans()

    def request(seq, seed, n, path):
        with spans.span("sample"):
            toks = sampler.block_ensemble(
                seq, n, block_length=traffic["block_length"],
                steps=traffic["steps_per_block"],
                temperature=traffic["temperature"], seed=seed,
                max_batch=traffic["max_batch"])
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
    request(reqs[-1]["sequence"][:traffic["warmup_residues"]],
            reqs[-1]["seed"], samples, out_dir / "w.pdb")
    phase("warm-up request")
    setup_s = time.monotonic() - job["t_start"]
    print(phase.line(), flush=True)

    rng = np.random.default_rng(s_watch)
    cap = traffic["capture"]
    watch_req = int(rng.integers(cap["requests"]))
    n_res = len(reqs[watch_req]["sequence"])
    plan = schedule(n_res, traffic["block_length"],
                    traffic["steps_per_block"])
    batch0 = min(samples, traffic["max_batch"])
    rows = np.sort(rng.choice(batch0, min(cap["rows"], batch0),
                              replace=False))
    step_fs = [f for f, s in enumerate(plan) if s[0] == "step"]
    keep = rng.choice(step_fs, cap["forwards"], replace=False).tolist()
    deep = rng.choice(keep, cap["deep"], replace=False).tolist()
    coord_rows = rng.choice(samples, cap["rows_rmsd"], replace=False)
    watch = None
    attempted = failed = completed = 0
    watched = peak = None
    spans = harness.Spans()
    t0 = time.perf_counter()
    while True:
        req = reqs[attempted]
        t_req = time.perf_counter()
        if attempted == watch_req:
            watch = Watch(runtime.trunk, plan, rows, keep, deep)
            # the batch shape the warm-up captured
            watch.wrap(sampler.block_forwards)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        try:
            toks, prots, ok = request(req["sequence"], req["seed"], samples,
                                      out_dir / "r.pdb")
        except Exception as e:  # a request that raises is counted failed
            print(f"request {attempted} raised: {e!r}", flush=True)
            ok = False
        if attempted == watch_req:
            watch.remove()
        if cuda:
            peak = max(peak or 0, torch.cuda.max_memory_allocated(device)
                       - (watch.nbytes() if attempted == watch_req else 0))
        if attempted == watch_req and ok:
            watched = (req, toks, [prots[int(j)].coordinates[:, :3]
                                   for j in coord_rows])
        print(f"request {attempted}: {len(req['sequence'])} residues, "
              f"{time.perf_counter() - t_req:.3f} s", flush=True)
        attempted += 1
        failed += not ok
        if ok:
            completed += samples
        if (time.perf_counter() - t0 >= job["seconds"]
                and attempted > watch_req):
            break
    window_s = time.perf_counter() - t0

    result = {"attempted": attempted, "failed": failed}
    if job["trace"]:
        ctx = {"window_s": window_s, "spans": dict(spans.seconds),
               "peak_bytes": peak, "trace": None, "config": cfg,
               "eager": None}
        if cuda:
            req = reqs[attempted]
            ctx["eager"] = eager_reading(request, traffic, req, samples,
                                         sampler, out_dir, sync)
            with torch.no_grad():
                ctx["trace"], _ = harness.traced(
                    lambda: request(req["sequence"], req["seed"], samples,
                                    out_dir / "t.pdb"), sync)
            print(f"traced request: {trace_counts(ctx['trace'])}; eager "
                  f"one-block request: {ctx['eager']}", flush=True)
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
    del sampler, runtime
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # no watched request completed: nothing to compare, so not correct
    controls = set(job.get("controls", ())) | (
        {control} if control in REFERENCE_CONTROLS else set())
    numbers = {} if watched is None else check(
        cfg, traffic, s_model, s_decoder, watch, watched, coord_rows,
        device, controls)
    if control in REFERENCE_CONTROLS:
        name = CONTROL_OF[control]
        numbers[name] = numbers.pop(f"{control}.{name}")
    result["rows_rmsd_A"] = numbers.pop("rows_rmsd_A", None)
    result["numbers"] = numbers
    print(f"route_ties: {numbers.get('route_ties')}, route_logit_err: "
          f"{numbers.get('route_logit_err')} (no limit)", flush=True)
    return result


def eager_reading(request, traffic, req, samples, sampler, out_dir, sync):
    """One request of the traced request's first ``eager_residues``
    residues, the window's batch shape, with the graphs off, under the
    profiler (module docstring): the device seconds launched inside
    ``moe.experts``, the busy seconds inside its ``sample`` range and the
    counters of its forwards, or None where the program has no spans.
    Its decode and PDB ranges pair the tracer's clock with the trace's
    as closely as the traced request's."""
    from benchmark import program

    seq = req["sequence"][:traffic["eager_residues"]]
    sampler.block_graphs = False
    try:
        with torch.no_grad():
            trace, _ = harness.traced(
                lambda: request(seq, req["seed"], samples,
                                out_dir / "e.pdb"), sync)
    finally:
        sampler.block_graphs = True
    ctx = {"trace": trace}
    found = program.spans(ctx)
    share = program.launched_share(ctx, "moe.experts")
    if found is None or share is None:
        return None
    c = counts_sdar.traced_counts(found)
    (a, b), = [(a, b) for n, a, b in trace.ranges if n == "sample"]
    busy = sum(max(0.0, min(b, y) - max(a, x))
               for x, y in trace.busy_intervals()) * 1e-6
    return {"experts_s": share / 100.0 * trace.device_s(),
            "busy_s": busy, "experts_hit": c.get("moe.experts_hit"),
            "tokens_routed": c.get("moe.tokens_routed"),
            "forwards": c.get("block.forwards"), **trace_counts(trace)}


def trace_counts(trace) -> dict:
    """For the record: the trace's device records, those of the grouped
    products (two a layer and forward), their device seconds and the
    busy and window seconds."""
    grouped = [b - a for n, a, b, _ in trace.kernels
               if "GroupProblemShape" in n]
    return {"kernels": len(trace.kernels), "grouped": len(grouped),
            "grouped_s": sum(grouped) * 1e-6,
            "device_s": trace.device_s(), "window_s": trace.window_s}


def tie_gap(z, ref_ids, prog_ids):
    """(T,): where the program's expert set differs from the reference's
    top-k (``ref_ids``) of logits z (T, E), the largest |z_e - z_k| of
    an expert in one set only (z_k the k-th largest): the least
    ``route_margin`` that reads the difference as a tie; else 0."""
    mine = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    mine.scatter_(1, ref_ids, True)
    theirs = torch.zeros_like(mine)
    theirs.scatter_(1, prog_ids, True)
    kth = z.gather(1, ref_ids).amin(-1, keepdim=True)
    return torch.where(mine != theirs, (z - kth).abs(), 0.0).amax(-1)


def rel(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


@torch.no_grad()
def check(cfg, traffic, s_model, s_decoder, watch, watched, coord_rows,
          device, controls=()) -> dict:
    """The reference's judgement of the watched request (module
    docstring); ``controls``: the controls' readings beside the program's,
    each as ``<control>.<number>``."""
    from benchmark.reference.model import Precision, set_precision

    set_precision()
    fp8 = Precision("fp8")
    w8a8 = RS.W8A8()
    req, final, coords = watched
    plan, rows = watch.plan, watch.rows.to(device)
    P = plan[0][2]
    L = cfg["num_hidden_layers"]
    eps = cfg["rms_norm_eps"]
    margin = traffic["capture"]["route_margin"]
    numbers = {"update_mismatch": 0, "route_mismatch": 0, "route_ties": 0}
    if set(watch.tokens) != set(range(len(plan))):   # forwards missed
        print(f"the watch saw forwards {sorted(watch.tokens)[:5]}... of "
              f"{len(plan)}", flush=True)
        numbers["update_mismatch"] = None
        return numbers
    # a short last block runs padded to the block width: its real
    # positions only
    width = [s_[2] for s_ in plan]
    tokens = {f: t[:, :width[f]].to(device)
              for f, t in watch.tokens.items()}
    routes_of = {f: r[:, :, :width[f]].to(device).long()
                 for f, r in watch.routes.items()}
    # the rows' whole sequences: the prompt, each block as committed
    committed = [tokens[f] for f, s in enumerate(plan) if s[0] == "commit"]
    done = torch.cat(committed, dim=1)
    got = torch.as_tensor(final[rows.cpu().numpy()], device=device).long()
    numbers["update_mismatch"] += int((got != done).sum())
    block_of = torch.cat([torch.zeros(P, dtype=torch.long, device=device),
                          1 + torch.arange(done.shape[1], device=device)
                          // traffic["block_length"]])
    commit_f = {s[1]: f for f, s in enumerate(plan) if s[0] == "commit"}

    n_steps = sum(s_[0] == "step" for s_ in plan)       # the update rule
    U = RS.block_uniforms(req["seed"], rows.tolist(),
                          traffic["block_length"], n_steps, device)
    for f, s_ in enumerate(plan):
        if s_[0] != "step":
            continue
        _, start, m, k, quota = s_
        nxt = RS.block_update(
            tokens[f], watch.logits[f][:, :m].to(device).float(), U[k][:, :m],
            torch.full((len(rows),), quota, device=device),
            traffic["temperature"])
        numbers["update_mismatch"] += int(
            (nxt != watch.after[f][:, :m].to(device)).sum())

    def whole(f):
        """The sequence forward f's block saw: (tokens, block ids, routes
        by layer (rows, n, k))."""
        start, m = plan[f][1], plan[f][2]
        parts = [0] + [g for s0, g in sorted(commit_f.items())
                       if s0 < start] + [f]
        toks = torch.cat([tokens[g] for g in parts], dim=1)
        routes = {i: torch.cat([routes_of[g][i] for g in parts], dim=1)
                  for i in range(L)}
        return toks, block_of[:start + m], routes

    top = weights_sdar.make_top(cfg, s_model, device)
    kept = sorted(watch.keep)
    stages_of = {f: {i: {k: v if k.endswith("_before") else v[:, :width[f]]
                         for k, v in st.items()}
                     for i, st in layers.items()}
                 for f, layers in watch.stages.items()}
    stage, stage8 = {}, {}
    z_err = gap = 0.0
    gaps8 = []
    state = []
    for f in kept:
        toks, bids, routes = whole(f)
        n = toks.shape[1]
        cos, sin = RS.rope(torch.arange(n, device=device), cfg["head_dim"],
                           cfg["rope_theta"])
        x0 = top["model.embed_tokens.weight"][toks]
        state.append([x0, cos, sin, bids[None, :] <= bids[:, None], routes,
                      x0])
    for i in range(L):
        W, p = weights_sdar.make_layer(cfg, i, s_model, device), \
            f"model.layers.{i}."
        ln1, ln2 = (W[p + "input_layernorm.weight"],
                    W[p + "post_attention_layernorm.weight"])
        for s in state:                         # the whole rows
            x, cos, sin, allowed, routes, _ = s
            ids = routes[i].reshape(-1, routes[i].shape[-1])
            x = x + RS.attention(W, p, RS.rms_norm(x, ln1, eps), cos, sin,
                                 allowed, cfg)
            s[0] = x + RS.moe(W, p, RS.rms_norm(x, ln2, eps), cfg, ids)[0]
            if "fp8" in controls:
                x = s[5] + RS.attention(W, p, RS.rms_norm(s[5], ln1, eps),
                                        cos, sin, allowed, cfg, fp8)
                s[5] = x + RS.moe(W, p, RS.rms_norm(x, ln2, eps), cfg, ids,
                                  prec=fp8)[0]
        for f, layers in sorted(stages_of.items()):      # the deep stages
            st = {k: v.to(device) for k, v in layers[i].items()}
            start, m = plan[f][1], plan[f][2]
            cos, sin = RS.rope(torch.arange(start, start + m, device=device),
                               cfg["head_dim"], cfg["rope_theta"])
            x = st["x"].float()
            want = RS.attention_after(W, p, RS.rms_norm(x, ln1, eps), cos,
                                      sin, st["k_before"], st["v_before"],
                                      cfg)
            stage[f"attn.{i}"] = max(stage.get(f"attn.{i}", 0.0),
                                     rel(st["attn"], want))
            h = st["h"].float()
            stage[f"residual.attn.{i}"] = max(
                stage.get(f"residual.attn.{i}", 0.0),
                rel(h[rows], x + st["attn"].float()))
            hn = RS.rms_norm(h, ln2, eps).reshape(-1, h.shape[-1])
            z = RS.mm(hn, W[p + "mlp.gate.weight"])
            z_err = max(z_err, float((st["z"].reshape(z.shape).float()
                                      - z).abs().max()))
            replayed = watch.all_routes[f][i][:, :m].to(device).long()
            replayed = replayed.reshape(-1, replayed.shape[-1])
            top_k = torch.topk(z, cfg["num_experts_per_tok"], dim=-1).indices
            gap = max(gap, float(tie_gap(z, top_k, replayed).max()))
            y, bad, ties = RS.moe(W, p, hn, cfg, replayed, margin)
            numbers["route_mismatch"] += bad
            numbers["route_ties"] += ties
            numbers["replay_eager_routes"] = numbers.get(
                "replay_eager_routes", 0) + int(
                (replayed != st["ids"].reshape(replayed.shape).long())
                .any(-1).sum())
            y = y.view(h.shape)
            stage[f"moe.{i}"] = max(stage.get(f"moe.{i}", 0.0),
                                    rel(st["moe"], y))
            if "int8" in controls:
                y8 = RS.moe(W, p, hn, cfg, replayed, margin,
                            expert_prec=w8a8)[0].view(h.shape)
                stage8[f"moe.{i}"] = max(stage8.get(f"moe.{i}", 0.0),
                                         rel(y8, y))
            if "fp8_router" in controls:
                gaps8.append(tie_gap(z, top_k, RS.route(
                    W, p, hn, cfg, prec=fp8)[1]))
            stage[f"residual.moe.{i}"] = max(
                stage.get(f"residual.moe.{i}", 0.0),
                rel(st["out"], h[rows] + st["moe"][rows].float()))
        del W
    for f, layers in sorted(stages_of.items()):
        st = layers["top"]
        want = RS.head(top, cfg, st["norm_in"].to(device).float())
        stage["head"] = max(stage.get("head", 0.0),
                            rel(st["logits"].to(device), want[..., :MASK]))
    numbers["stage_err"] = max(stage.values()) if stage else None
    if "int8" in controls and stage:
        numbers["int8.stage_err"] = max({**stage, **stage8}.values())
    numbers["route_logit_err"] = z_err
    numbers["route_tie_gap"] = gap
    if gaps8:
        gaps8 = torch.cat(gaps8)
        numbers["fp8_router.route_mismatch"] = int((gaps8 > margin).sum())
        for m_ in MARGINS:
            numbers[f"fp8_router.over.{m_}"] = int((gaps8 > m_).sum())
    for kind in ("attn", "moe", "residual", "head"):
        numbers[f"stage.{kind}"] = max(
            (v for n_, v in stage.items() if n_.split(".")[0] == kind),
            default=None)
    worst = worst8 = 0.0
    for f, s in zip(kept, state):
        start, m = plan[f][1], plan[f][2]
        want = RS.head(top, cfg, s[0][:, start:start + m])[..., :MASK]

        def err(got):
            return float(((got - want).norm(dim=-1)
                          / want.norm(dim=-1)).max())

        worst = max(worst, err(watch.logits[f][:, :m].to(device).float()))
        if "fp8" in controls:
            worst8 = max(worst8, err(RS.head(
                top, cfg, s[5][:, start:start + m], fp8)[..., :MASK]))
    numbers["logits_rel_err"] = worst
    if "fp8" in controls:
        numbers["fp8.logits_rel_err"] = worst8
    del top, state

    W = weights.make(weights.decoder_shapes(cfg["decoder"]), s_decoder,
                     device)
    toks = torch.as_tensor(final[coord_rows].astype(np.int64), device=device)
    toks = torch.cat([torch.full((len(coord_rows), 1), R.STRUCT_BOS,
                                 device=device), toks,
                      torch.full((len(coord_rows), 1), R.STRUCT_EOS,
                                 device=device)], dim=1)
    bb = R.decode_backbone(W, cfg["decoder"], toks)[:, 1:-1]
    got = torch.as_tensor(np.stack(coords), device=device,
                          dtype=torch.float32)
    rmsd = ((got - bb) ** 2).sum(-1).mean(dim=(1, 2)).sqrt()
    numbers["coord_rmsd_A"] = float(rmsd.mean())
    numbers["coord_rows_over"] = int(
        (rmsd > traffic["capture"]["row_rmsd_A"]).sum())
    numbers["rows_rmsd_A"] = rmsd.tolist()
    return numbers
