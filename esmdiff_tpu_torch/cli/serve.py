"""Warm conformation-sampling server on the port.

Port of ``esmdiff_tpu/cli/serve.py``: the model loads once per process and
stays on the card across requests.  ``--data_parallel`` puts a replica of
the trunk on every visible card behind the one ``SamplerService``; each
batch's rows split across them.

Endpoints (JSON over HTTP, stdlib only):

  GET  /healthz  -> {"ok": true, "device": ..., "card": ..., ...}
  POST /sample   <- {"sequence": str, "num_samples": int,
                     "mode": "gibbs"|"ddpm"|"eb" (default gibbs),
                     "num_steps": int (ddpm 25, else 16), "temperature":
                     float, "top_p": float, "entropy_budget": float (eb),
                     "seed": int, "pdb": str (a sequence source, and the
                     inpainting prior), "mask_ids": [int] (residues to
                     inpaint: gibbs, ddpm), "ref_compat": bool (ddpm),
                     "format": "pdb"|"tokens"}
                 -> {"pdb": str} | {"tokens": [[int], ...]}, plus timings
  POST /warmup   <- {"lengths": [int], "num_samples": int, "mode": str,
                     "num_steps": int, "packed_lengths": [int]}
                 -> seconds per warmed length (the first request at a shape
                    pays cuBLAS set-up and allocator growth)

Device work is serialized per phase by two locks (trunk sampling, VQ
decode), so request B's sampling can run behind request A's decode.
Concurrent gibbs or ddpm requests with the same (mode, num_steps,
temperature, top_p) and no prior coalesce into one group while they queue
behind in-flight device work: a ddpm group within one length bucket runs
one merged batch plan, a ddpm group across buckets is cost-routed between
per-bucket batches and one cross-length packed program
(``EnsembleSampler.ddpm_ensemble_mixed``); a gibbs group runs per-bucket
sub-groups (``gibbs_ensemble_mixed``).  eb requests run alone (their step
count is per batch).  A sample's draws depend only on its request's seed
and its index, so a request's tokens do not depend on its co-batched
traffic.

    python -m esmdiff_tpu_torch.cli.serve --quant int8 --mode ddpm
"""

from __future__ import annotations

import argparse
import functools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from esmdiff_tpu_torch.api.generation import (EnsembleSampler,
                                              GenerationConfig, bucket_length)
from esmdiff_tpu_torch.api.protein_api import ESMProtein
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.core.tokenizer import SequenceTokenizer


class RequestError(ValueError):
    """Client error -> HTTP 400 with a JSON message."""


_VALID_MODES = ("gibbs", "ddpm", "eb")
_MAX_SEQ_LEN = 2048


@functools.cache
def _valid_residues() -> frozenset:
    """The residue alphabet the sequence tokenizer accepts (its one-letter
    alphabetic entries) plus '_' (mask); anything else would encode as UNK
    or as a non-residue token."""
    return frozenset(t for t in SequenceTokenizer.vocab
                     if len(t) == 1 and t.isalpha()) | {"_"}


class _Pending:
    """One coalescable request waiting for its group's device run."""

    __slots__ = ("seq", "n", "fmt", "seed", "event", "tokens", "prots",
                 "sampling_sec", "group_size", "error")

    def __init__(self, seq: str, n: int, fmt: str, seed: int):
        self.seq, self.n, self.fmt, self.seed = seq, n, fmt, seed
        self.event = threading.Event()
        self.tokens = self.prots = self.error = None
        self.sampling_sec = 0.0
        self.group_size = 1


class SamplerService:
    """Owns the sampler; serializes device access per phase."""

    def __init__(self, sampler: EnsembleSampler, max_samples: int = 512,
                 coalesce: bool = True, max_batch: int | None = None):
        self.sampler = sampler
        self.max_samples = max_samples
        self.max_batch = max_batch    # batch-plan cap of every request
        self._sample_lock = threading.Lock()
        self._decode_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._stats: dict = {}        # per-mode latency aggregates
        self._coalesce = coalesce
        self._pending: dict = {}
        self._pending_lock = threading.Lock()
        self._coalesce_stats = {"groups": 0, "coalesced_requests": 0,
                                "max_group": 0}

    # -- introspection ---------------------------------------------------------
    def health(self) -> dict:
        rt = self.sampler.runtime
        cfg = rt.trunk.cfg
        return {
            "ok": True,
            "device": str(rt.device),
            "card": (torch.cuda.get_device_name(rt.device)
                     if rt.device.type == "cuda" else None),
            "model": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                      "head_type": cfg.head_type, "quant": cfg.quant},
            "requests_served": self._n_requests,
            "latency": {k: {**v, "mean_sec": round(v["mean_sec"], 3)}
                        for k, v in list(self._stats.items())},
            "coalesce": {"enabled": self._coalesce,
                         **dict(self._coalesce_stats)},
        }

    # -- sampling --------------------------------------------------------------
    def sample(self, req: dict) -> dict:
        p = self._parse(req)
        t0 = time.time()
        if (self._coalesce and p["prior_prot"] is None
                and p["mode"] != "eb"):
            tokens, prots, t_tokens, gsize = self._run_coalesced(p)
        else:
            tokens, prots, t_tokens = self._run_single(p)
            gsize = 1
        wall = time.time() - t0
        with self._stats_lock:
            self._n_requests += 1
            st = self._stats.setdefault(
                p["mode"], {"count": 0, "last_sec": 0.0, "mean_sec": 0.0})
            st["count"] += 1
            st["last_sec"] = round(wall, 3)
            st["mean_sec"] += (wall - st["mean_sec"]) / st["count"]

        out: dict = {"mode": p["mode"], "num_samples": p["n"],
                     "num_steps": p["steps"],
                     "sampling_sec": round(t_tokens, 3)}
        if gsize > 1:
            out["coalesced"] = gsize  # batched with gsize-1 other requests
        if p["fmt"] == "tokens":
            out["tokens"] = np.asarray(tokens).tolist()
        else:
            # PDB text in the request's own thread, outside the locks
            out["pdb"] = protein_io.ensemble_to_pdb(
                [pr.to_protein() for pr in prots])
            out["total_sec"] = round(time.time() - t0, 3)
        return out

    def _parse(self, req: dict) -> dict:
        """The JAX server's checks, in its order."""
        seq = req.get("sequence")
        prior_prot = None
        if req.get("pdb"):
            prior_prot = ESMProtein.from_pdb_string(req["pdb"])
            seq = seq or prior_prot.sequence
        if not seq or not isinstance(seq, str):
            raise RequestError("missing 'sequence' (or 'pdb') field")
        if len(seq) > _MAX_SEQ_LEN:
            raise RequestError(f"sequence too long ({len(seq)} > "
                               f"{_MAX_SEQ_LEN})")
        bad_chars = set(seq) - _valid_residues()
        if bad_chars:
            raise RequestError(
                f"invalid residue characters: {sorted(bad_chars)}")
        mode = req.get("mode", "gibbs")
        if mode not in _VALID_MODES:
            raise RequestError(f"mode must be one of {_VALID_MODES}")
        rt = self.sampler.runtime
        if mode == "ddpm" and (rt.trunk.cfg.head_type != "structure"
                               or rt.sigma_embedder is None):
            raise RequestError(
                "this server's model cannot run ddpm (it was loaded with the "
                "stock esm3 head / no sigma embedder — start with a "
                "fine-tuned --ckpt or --mode ddpm to serve ddpm)")
        n = int(req.get("num_samples", 10))
        if not 1 <= n <= self.max_samples:
            raise RequestError(f"num_samples must be in [1, "
                               f"{self.max_samples}]")
        steps = int(req.get("num_steps", 25 if mode == "ddpm" else 16))
        seed = int(req.get("seed", 0))
        temperature = float(req.get("temperature", 1.4))
        top_p = float(req.get("top_p", 0.9))
        mask_ids = req.get("mask_ids")
        fmt = req.get("format", "pdb")
        if fmt not in ("pdb", "tokens"):
            raise RequestError("format must be 'pdb' or 'tokens'")
        if mask_ids is not None:
            if mode == "eb":
                raise RequestError("eb mode does not support inpainting "
                                   "(mask_ids) — use gibbs or ddpm")
            mask_ids = [int(i) for i in mask_ids]
            bad = [i for i in mask_ids if not 0 <= i < len(seq)]
            if bad:
                raise RequestError(f"mask_ids out of range: {bad}")
            if prior_prot is None:
                raise RequestError("inpainting (mask_ids) needs a 'pdb' "
                                   "prior structure")
        if prior_prot is not None and len(prior_prot.sequence) != len(seq):
            raise RequestError(
                f"'sequence' length {len(seq)} != 'pdb' prior length "
                f"{len(prior_prot.sequence)}")
        return {"seq": seq, "mode": mode, "n": n, "steps": steps,
                "seed": seed, "temperature": temperature, "top_p": top_p,
                "mask_ids": mask_ids, "fmt": fmt, "prior_prot": prior_prot,
                "ref_compat": bool(req.get("ref_compat", False)),
                "entropy_budget": float(req.get("entropy_budget", 1.0))}

    def _run_single(self, p: dict):
        """Un-coalesced path (inpainting priors, eb, a 'pdb' sequence
        source, --coalesce off)."""
        mask_ids, prior_prot = p["mask_ids"], p["prior_prot"]
        with self._sample_lock:
            t_dev = time.time()  # sampling_sec = device phase, not queueing
            if p["mode"] == "gibbs":
                tokens = self.sampler.gibbs_ensemble(
                    p["seq"], p["n"], config=_gibbs_config(p),
                    seed=p["seed"],
                    coordinates=(prior_prot.coordinates
                                 if mask_ids is not None else None),
                    mask_ids=mask_ids, max_batch=self.max_batch)
            elif p["mode"] == "ddpm":
                structure_tokens = None
                if mask_ids is not None:
                    structure_tokens = self.sampler.runtime.encode(
                        prior_prot).structure
                tokens = self.sampler.ddpm_ensemble(
                    p["seq"], p["n"], num_steps=p["steps"], seed=p["seed"],
                    mask_ids=mask_ids, structure_tokens=structure_tokens,
                    ref_compat=p["ref_compat"], max_batch=self.max_batch)
            else:
                tokens = self.sampler.eb_ensemble(
                    p["seq"], p["n"], entropy_budget=p["entropy_budget"],
                    temperature=p["temperature"], top_p=p["top_p"],
                    max_steps=p["steps"] * 8, seed=p["seed"],
                    max_batch=self.max_batch)
            t_tokens = time.time() - t_dev
        prots = None
        if p["fmt"] == "pdb":
            # phase 2 under its own lock: the next request's sampling can
            # already run
            with self._decode_lock:
                prots = self.sampler.decode_ensemble(p["seq"], tokens)
        return tokens, prots, t_tokens

    def _run_coalesced(self, p: dict):
        """Enqueue into the group of this request's key; the group's first
        arrival leads: it takes the sample lock (requests pile up behind
        the in-flight device work), drains what queued meanwhile and runs
        the group at once."""
        item = _Pending(p["seq"], p["n"], p["fmt"], p["seed"])
        gkey = (p["mode"], p["steps"], p["temperature"], p["top_p"])
        with self._pending_lock:
            q = self._pending.setdefault(gkey, [])
            q.append(item)
            leader = len(q) == 1
        if leader:
            self._lead_group(gkey, p)
        # the bound only guards against a leader thread dying without its
        # finally (which always signals)
        if not item.event.wait(timeout=3600):
            raise RuntimeError("coalesced sampling timed out")
        if item.error is not None:
            raise item.error
        return item.tokens, item.prots, item.sampling_sec, item.group_size

    def _lead_group(self, gkey, p: dict) -> None:
        group = []
        try:
            with self._sample_lock:
                with self._pending_lock:
                    group = self._pending.pop(gkey, [])
                if not group:
                    return  # drained by an earlier leader of this key
                t_dev = time.time()
                seqs = [it.seq for it in group]
                counts = [it.n for it in group]
                seeds = [it.seed for it in group]
                if p["mode"] == "gibbs":
                    toks_list = self.sampler.gibbs_ensemble_mixed(
                        seqs, counts, config=_gibbs_config(p), seeds=seeds,
                        max_batch=self.max_batch)
                else:
                    engine = (self.sampler.ddpm_ensemble_mixed
                              if len({bucket_length(len(s) + 2)
                                      for s in seqs}) > 1
                              else self.sampler.ddpm_ensemble_multi)
                    toks_list = engine(seqs, counts, num_steps=p["steps"],
                                       seeds=seeds, max_batch=self.max_batch)
                t_tokens = time.time() - t_dev
            # phase 2 outside the sample lock
            need = [i for i, it in enumerate(group) if it.fmt == "pdb"]
            prots_by: dict = {}
            if need:
                with self._decode_lock:
                    dec = self.sampler.decode_ensemble_multi(
                        [group[i].seq for i in need],
                        [toks_list[i] for i in need])
                prots_by = dict(zip(need, dec))
            for i, it in enumerate(group):
                it.tokens = toks_list[i]
                it.prots = prots_by.get(i)
                it.sampling_sec = t_tokens
                it.group_size = len(group)
            with self._stats_lock:
                cs = self._coalesce_stats
                cs["groups"] += 1
                cs["coalesced_requests"] += len(group) - 1
                cs["max_group"] = max(cs["max_group"], len(group))
        except Exception as e:  # noqa: BLE001 — deliver to every waiter
            for it in group:
                it.error = e
        finally:
            for it in group:
                it.event.set()

    def warmup(self, req: dict) -> dict:
        """Run one request per length (and, with ``packed_lengths``, one
        cross-length packed group) so later requests at those shapes find
        cuBLAS and the allocator warm.  Returns seconds per entry.  The
        packed run is the ddpm engine's, whatever the mode (as in JAX)."""
        lengths = req.get("lengths") or (
            [] if req.get("packed_lengths") else [64])
        n = int(req.get("num_samples", 10))
        mode = req.get("mode", "gibbs")
        steps = int(req.get("num_steps", 25 if mode == "ddpm" else 16))
        fmt = req.get("format", "pdb")   # "pdb" warms the decoder too
        report = {}

        def _seq(L: int) -> str:
            return ("ACDEFGHIKLMNPQRSTVWY" * (L // 20 + 1))[:L]

        for L in lengths:
            L = int(L)
            if not 2 < L <= _MAX_SEQ_LEN:
                raise RequestError(f"warmup length out of range: {L}")
            t0 = time.time()
            self.sample({"sequence": _seq(L), "num_samples": n,
                         "mode": mode, "num_steps": steps, "format": fmt})
            report[str(L)] = round(time.time() - t0, 2)
        if req.get("packed_lengths"):
            pls = [int(x) for x in req["packed_lengths"]]
            for L in pls:
                if not 2 < L <= _MAX_SEQ_LEN:
                    raise RequestError(
                        f"packed warmup length out of range: {L}")
            t0 = time.time()
            with self._sample_lock:
                self.sampler.ddpm_ensemble_packed(
                    [_seq(L) for L in pls], [n] * len(pls),
                    num_steps=steps, seeds=list(range(len(pls))))
            report["packed:" + ",".join(map(str, pls))] = round(
                time.time() - t0, 2)
        return {"warmed": report}


def _gibbs_config(p: dict) -> GenerationConfig:
    return GenerationConfig(num_steps=p["steps"],
                            temperature=p["temperature"], top_p=p["top_p"])


def make_handler(service: SamplerService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 — quiet
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply(200, service.health())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad request body: {e}"})
            if not isinstance(req, dict):
                return self._reply(
                    400, {"error": "request body must be a JSON object"})
            try:
                if self.path == "/sample":
                    self._reply(200, service.sample(req))
                elif self.path == "/warmup":
                    self._reply(200, service.warmup(req))
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except RequestError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — keep the server alive
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(service: SamplerService, host: str = "127.0.0.1",
          port: int = 8000) -> ThreadingHTTPServer:
    """The HTTP server, bound and not yet serving (``serve_forever``)."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def get_argparser():
    from esmdiff_tpu_torch.cli.sample import get_argparser as sample_parser

    p = argparse.ArgumentParser(
        description="Warm conformation-sampling HTTP server (PyTorch port).",
        parents=[sample_parser()], conflict_handler="resolve")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_samples", type=int, default=512,
                   help="Per-request num_samples cap.")
    p.add_argument("--coalesce", choices=("on", "off"), default="on",
                   help="Merge concurrent requests into one device run.")
    p.add_argument("--warmup_lengths", type=str, default=None,
                   help="Comma-separated sequence lengths to run once "
                        "before accepting traffic (e.g. 64,128,256).")
    p.add_argument("--warmup_packed", type=str, default=None,
                   help="Comma-separated lengths of an expected mixed "
                        "group (e.g. 58,120,250): one cross-length packed "
                        "run before accepting traffic.")
    # None = /sample's per-mode default (ddpm 25, else 16) unless the
    # operator sets it
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--max_batch", type=int, default=64)
    return p


def main(argv=None):
    from esmdiff_tpu_torch.cli.sample import (build_runtime,
                                              data_parallel_devices)

    args = get_argparser().parse_args(argv)
    runtime = build_runtime(args)
    if args.quant == "int8":
        print("[quant] trunk projections running W8A8 int8")
    devices = data_parallel_devices(runtime) if args.data_parallel else None
    if devices:
        print(f"[data_parallel] sampling across {len(devices)} device(s)")
    service = SamplerService(EnsembleSampler(runtime, devices=devices),
                             max_samples=args.max_samples,
                             coalesce=args.coalesce == "on",
                             max_batch=args.max_batch)
    if args.warmup_lengths or args.warmup_packed:
        lengths = ([int(x) for x in args.warmup_lengths.split(",")]
                   if args.warmup_lengths else [])
        wreq = {"lengths": lengths, "mode": args.mode,
                "num_samples": args.num_samples}
        if args.warmup_packed:
            wreq["packed_lengths"] = [
                int(x) for x in args.warmup_packed.split(",")]
        if args.num_steps is not None:
            wreq["num_steps"] = args.num_steps
        print(f"[warmup] lengths {lengths} ...")
        print(f"[warmup] {service.warmup(wreq)['warmed']}")
    httpd = serve(service, args.host, args.port)
    print(f"[serve] listening on http://{args.host}:{httpd.server_port} "
          f"on {runtime.device} (POST /sample, /warmup; GET /healthz)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
