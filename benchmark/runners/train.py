"""Training cells: MDLM fine-tuning of the trunk as ``esmdiff-torch-train``
runs it, through the trainer's own data path and step.

Set-up: a corpus of seeded chains (``generator.training_chains``) written
in the dump's encoding format (``.npz`` with BOS/EOS) under the run's
TMPDIR; the trainer's model (``train/loop.py::build_task``), filled by its
converter (``convert_mdlm``) from seeded weights in the published layout,
float32 master weights, its AdamW and train state; then the first
``warmup_steps`` steps, through the same loader (``EncodingDataset``,
``data.batches``: packed rows, epoch after epoch with the trainer's seeds)
and ``train/state.py::train_step`` that the window drives.  Those steps
are the ones the reference follows.  Each phase's seconds are printed on
one line.

The window runs steps until the one that crosses ``seconds`` ends; it
counts the real (non-padding) tokens of every step.  ``memory_peak_bytes``
is ``max_memory_allocated`` over the window's steps, set-up and its seeded
float32 buffers left out.  After the window the program is freed and the
float32 reference runs the same first steps on the same chains and draws:

  loss_rel_gap    |loss - loss_ref| / |loss_ref| of the first step (the
                  later steps' losses weigh a few tokens of the segments
                  drawn near t = 0 by up to 1/t: their gap swings from
                  seed to seed, PERF.md);
  grad_norm_gap   the first step's gradient as the optimizer took it (its
                  first moment after one step / (1 - b1)), by the worst
                  leaf: | |g| - |g_ref| | / max(|g_ref|, the median leaf's);
  change_gap      the parameters' change over the first steps, as step
                  ``warmup_steps + 1`` finds them, by the worst leaf as
                  above.
Leaves whose reference gradient is under a thousandth of the median
leaf's (nought but for rounding: no path from the loss reaches them) are
left out of the last two.
"""

from __future__ import annotations

import gc
import itertools
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import counts, generator, harness, weights
from benchmark.reference import model as R
from benchmark.reference import train as RT

B1 = 0.9


def write_corpus(chains, out: Path) -> None:
    for i, (seq, st) in enumerate(chains):
        np.savez(out / f"c{i:05d}.npz",
                 sequence_tokens=np.concatenate([[R.SEQ_BOS], seq,
                                                 [R.SEQ_EOS]]).astype(np.int32),
                 structure_tokens=np.concatenate(
                     [[R.STRUCT_BOS], st, [R.STRUCT_EOS]]).astype(np.int32))


def train_config(cfg: dict, traffic: dict, corpus: Path, seed: int):
    from esmdiff_tpu_torch.train.config import TrainConfig

    t, o = cfg["trunk"], cfg["train"]
    tc = TrainConfig()
    tc.task_name, tc.seed = "mdlm", seed
    tc.data.path = str(corpus)
    tc.data.batch_size = traffic["batch_size"]
    tc.data.max_len = traffic["max_len"]
    tc.data.pack_len = traffic["pack_len"]
    m = tc.model
    m.size = "custom"
    m.d_model, m.n_heads = t["d_model"], t["n_heads"]
    m.n_layers, m.v_heads = t["n_layers"], t["v_heads"]
    m.n_structure_heads, m.dtype = t["n_structure_heads"], t["dtype"]
    m.param_dtype, m.remat = o["param_dtype"], o["remat"]
    m.noise = o["noise"]
    tc.optim.lr, tc.optim.weight_decay = o["lr"], o["weight_decay"]
    return tc


def shapes(cfg: dict) -> dict:
    s = weights.trunk_shapes(cfg["trunk"])
    s.update(weights.sigma_shapes(cfg["trunk"]))
    return s


def run(job: dict) -> dict:
    with tempfile.TemporaryDirectory(prefix="bench_corpus_") as corpus:
        return _run(job, Path(corpus))


def _run(job: dict, corpus: Path) -> dict:
    from esmdiff_tpu_torch.convert import torch_ckpt
    from esmdiff_tpu_torch.device import torch_dtype
    from esmdiff_tpu_torch.diffusion.mdlm import GeneratorDraws
    from esmdiff_tpu_torch.train import data as data_mod
    from esmdiff_tpu_torch.train import loop
    from esmdiff_tpu_torch.train import state as tstate

    cfg, traffic, device = job["config"], job["traffic"], job["device"]
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    phase = harness.Phases(job["t_start"], sync)
    phase("imports")
    s_weights, s_data, s_run = harness.seeds(job["seed"], 3)
    chains = generator.training_chains(traffic, s_data)
    write_corpus(chains, corpus)
    phase("corpus")

    tc = train_config(cfg, traffic, corpus, s_run)
    mdlm, loss_fn = loop.build_task(tc, device)
    phase("model")
    W = weights.make(shapes(cfg), s_weights, device)
    torch_ckpt.convert_mdlm(mdlm.net, mdlm.sigma_embedder, {
        (k if k.startswith("sigma_embedder.") else "net." + k): v
        for k, v in W.items()})
    del W
    modules = loop.mdlm_modules(mdlm)
    loop.cast_params(modules, torch_dtype(tc.model.param_dtype))
    phase("weights")
    loss_fn, layout = tstate.distribute(
        modules, loss_fn, tc.trainer.strategy, tc.data.batch_size, device)
    optimizer = tstate.make_optimizer(
        modules.parameters(), lr=tc.optim.lr,
        weight_decay=tc.optim.weight_decay,
        warmup_steps=tc.optim.warmup_steps, grad_clip=tc.optim.grad_clip,
        layout=layout)
    state = tstate.create_train_state(modules, optimizer, layout)
    draws = GeneratorDraws(device, seed=tc.seed)
    split = data_mod.Split(data_mod.EncodingDataset(tc.data),
                           np.arange(len(chains)))
    phase("optimizer and dataset")

    def epochs():
        for epoch in itertools.count():
            yield from data_mod.batches(split, tc.data, shuffle=True,
                                        seed=tc.seed + epoch)

    feed = epochs()
    spans = harness.Spans()

    def step():
        with spans.span("data"):
            b = next(feed)
            batch = loop.to_device(b, device)
        with spans.span("step"):
            out = tstate.train_step(state, loss_fn, batch, draws)
        return b, out

    # the first steps: warm-up, and the steps the reference follows
    names = weights.port_names(cfg["trunk"])
    leaves = dict(modules.named_parameters())
    losses, t_reading = [], 0.0
    for i in range(traffic["warmup_steps"]):
        _, out = step()
        losses.append(float(out["loss"]))
        if i == 0:
            t = time.monotonic()
            moments = optimizer.adamw.state
            grad1 = {names[n]: float(moments[p]["exp_avg"].norm()) / (1 - B1)
                     if "exp_avg" in moments.get(p, {}) else 0.0
                     for n, p in leaves.items()}
            t_reading += time.monotonic() - t
    phase("first steps")
    t = time.monotonic()
    W0 = weights.make(shapes(cfg), s_weights, device)
    change = {names[n]: float((p.detach().float() - W0[names[n]]).norm())
              for n, p in leaves.items()}
    del W0
    t_reading += time.monotonic() - t
    sync()
    setup_s = time.monotonic() - job["t_start"] - t_reading
    print(phase.line(), flush=True)
    if cuda:    # the peak of the window's steps: set-up's buffers left out
        torch.cuda.reset_peak_memory_stats(device)

    spans = harness.Spans()
    segments, window_losses = [], []
    tokens = 0.0
    t0 = time.perf_counter()
    while True:
        b, out = step()
        tokens += float(b["mask"].sum())
        segments.append(b["segment_ids"])
        window_losses.append(out["loss"])
        if time.perf_counter() - t0 >= job["seconds"]:
            sync()
            break
    window_s = time.perf_counter() - t0
    attempted = len(window_losses)
    failed = int(sum(not np.isfinite(float(v)) for v in window_losses))
    peak = torch.cuda.max_memory_allocated(device) if cuda else None

    result = {"attempted": attempted, "failed": failed, "peak_bytes": peak}
    if job["trace"]:
        ctx = {"window_s": window_s, "spans": dict(spans.seconds),
               "peak_bytes": peak, "trace": None,
               "work_flops": sum(counts.train_step_flops(
                   cfg, segment_lengths(s)) for s in segments)}
        if cuda:
            ctx["trace"], _ = harness.traced(
                lambda: [step() for _ in range(traffic["trace_steps"])],
                sync)
            result["breakdown"] = {"device_ops": ctx["trace"].top_ops(),
                                   "idle_gaps": ctx["trace"].idle_gaps()}
            result["trace_device"] = {"busy_s": ctx["trace"].busy_s,
                                      "window_s": ctx["trace"].window_s}
        result["metrics"] = harness.read_metrics(job["per_layer"], ctx)
    else:
        result["metrics"] = {
            "train_tokens_per_s": {"value": tokens / window_s,
                                   "unit": "tokens/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    del state, optimizer, modules, mdlm, loss_fn, leaves, feed, split
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(cfg, traffic, chains, s_weights, tc.seed,
                             device)
    result["numbers"] = gaps((losses, grad1, change), ref)
    result["losses"] = [losses, ref[0]]
    return result


def segment_lengths(segment_ids: np.ndarray) -> list[int]:
    out = []
    for row in segment_ids:
        ids = row[row >= 0]
        if len(ids):
            out.extend(np.bincount(ids).tolist())
    return [n for n in out if n]


def reference_readings(cfg, traffic, chains, s_weights, seed, device,
                       precision="float32"):
    """The reference's first steps on the same chains and draws: (losses,
    first gradient norm per key, change norm per key)."""
    R.set_precision()
    W = weights.make(shapes(cfg), s_weights, device)
    W0 = {k: v.clone() for k, v in W.items()}
    batches = ({k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in RT.packed_batches(chains, traffic["batch_size"],
                                          traffic["pack_len"], seed))
    losses, grad1 = RT.train(
        W, cfg["trunk"], batches, seed, traffic["warmup_steps"],
        cfg["train"]["lr"], cfg["train"]["weight_decay"],
        R.Precision(precision))
    change = {k: float((W[k] - W0[k]).norm()) for k in W}
    return losses, grad1, change


def gaps(prog, ref) -> dict:
    """The numbers compared (module docstring) of the readings ``prog``
    against the reference's ``ref``, each (losses, grad1, change)."""
    (losses, grad1, change), (r_losses, r_grad1, r_change) = prog, ref
    median = float(np.median(list(r_grad1.values())))
    kept = [k for k, v in r_grad1.items() if v >= 1e-3 * median]

    def worst(p, r):
        floor = float(np.median([r[k] for k in kept]))
        return max(abs(p[k] - r[k]) / max(r[k], floor) for k in kept)

    return {"loss_rel_gap": abs(losses[0] - r_losses[0]) / abs(r_losses[0]),
            "grad_norm_gap": worst(grad1, r_grad1),
            "change_gap": worst(change, r_change)}
