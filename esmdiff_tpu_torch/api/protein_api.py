"""ESMProtein-style state API over the port's models (port of the decode
surface of ``esmdiff_tpu/api/protein_api.py``)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.core import residue_constants as rc
from esmdiff_tpu_torch.core.tokenizer import SequenceTokenizer
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.esm3 import ESM3, ESM3Config
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, StructureTokenDecoder
from esmdiff_tpu_torch.nn.layers import (Dense, TimestepEmbedder,
                                         cast_matmul_weights, init_params)
from esmdiff_tpu_torch.ops.quant import quantize_trunk_params


@dataclasses.dataclass
class ESMProtein:
    """Sequence + optional atom37 coordinates."""

    sequence: str
    coordinates: Optional[np.ndarray] = None  # (L, 37, 3), NaN where unknown

    @classmethod
    def from_pdb(cls, path: str | Path, chain_id: str | None = None):
        return cls._from_parsed(
            protein_io.from_pdb_file(path, chain_id=chain_id))

    @classmethod
    def from_pdb_string(cls, pdb_str: str, chain_id: str | None = None):
        return cls._from_parsed(
            protein_io.from_pdb_string(pdb_str, chain_id=chain_id))

    @classmethod
    def _from_parsed(cls, prot):
        if isinstance(prot, list):
            prot = prot[0]
        coords = prot.atom_positions.copy()
        coords[prot.atom_mask < 0.5] = np.nan
        return cls(sequence=prot.sequence, coordinates=coords)

    def to_protein(self) -> protein_io.Protein:
        L = len(self.sequence)
        if self.coordinates is None:
            raise ValueError("No coordinates to write")
        coords = np.nan_to_num(self.coordinates, nan=0.0)
        mask = np.isfinite(self.coordinates).all(axis=-1).astype(np.float32)
        return protein_io.Protein(
            atom_positions=coords.astype(np.float32),
            atom_mask=mask,
            aatype=rc.sequence_to_restype_indices(self.sequence),
            residue_index=np.arange(1, L + 1, dtype=np.int32),
            b_factors=np.zeros((L, rc.atom_type_num), dtype=np.float32),
        )

    def backbone(self) -> np.ndarray:
        """(L, 3, 3) N/CA/C with NaN where unknown."""
        return self.coordinates[:, list(rc.BACKBONE_ATOM_INDICES), :]


class ESM3Runtime:
    """Bundles the trunk, the VQ decoder and the sigma embedder (modules
    holding their parameters, all on ``device``) and exposes the decode
    surface the samplers and the CLI use."""

    def __init__(self, trunk: ESM3, decoder: StructureTokenDecoder,
                 sigma_embedder: Optional[TimestepEmbedder] = None,
                 device=None):
        self.device = resolve_device(device)
        self.trunk = trunk.to(self.device).eval()
        self.decoder = decoder.to(self.device).eval()
        self.sigma_embedder = (None if sigma_embedder is None
                               else sigma_embedder.to(self.device).eval())
        self.seq_tokenizer = SequenceTokenizer()

    @classmethod
    def random_init(cls, seed: int = 0,
                    trunk_cfg: Optional[ESM3Config] = None,
                    decoder_cfg: Optional[DecoderConfig] = None,
                    device=None, quant: str = "none") -> "ESM3Runtime":
        """Random weights from ``seed`` — for tests, benchmarks and dev.

        The modules are built and initialised on ``device``, so the 1.4B
        trunk never initialises on the host; matmul weights are then stored
        in each module's compute dtype (see ``cast_matmul_weights``).
        quant: "int8" quantizes the trunk (``quantize``) from its float32
        weights, before that cast, as the JAX package quantizes its float32
        params; the other weights are those of ``quant="none"``."""
        dev = resolve_device(device)
        trunk_cfg = trunk_cfg or ESM3Config()
        decoder_cfg = decoder_cfg or DecoderConfig()
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.device(dev):
            trunk = ESM3(trunk_cfg)
            decoder = StructureTokenDecoder(decoder_cfg)
            sig = TimestepEmbedder(trunk_cfg.d_model,
                                   dtype=trunk_cfg.torch_dtype)
        for m in (trunk, decoder, sig):
            init_params(m, gen)
        if quant != "none":
            trunk = _quantized(trunk, quant)
        for m in (trunk, decoder, sig):
            cast_matmul_weights(m)
        return cls(trunk, decoder, sig, device=dev)

    def quantize(self, mode: str = "int8",
                 include_decoder: bool = False) -> "ESM3Runtime":
        """A runtime whose trunk runs W8A8 int8 projections (ops/quant.py);
        attention cores, LayerNorms, embeddings and heads keep their dtype.
        The sigma embedder is shared, and the decoder too unless
        ``include_decoder`` quantizes its stack (off by default, as in JAX:
        trunk-only quantization leaves decoded coordinates unchanged for the
        same tokens).

        It quantizes the weights the modules hold.  The JAX package
        quantizes float32 params, so a module whose matmul weights are
        held in a narrower dtype (``random_init`` of a bf16 config stores
        them so) raises: its int8 weights would differ from JAX's.  Build
        such a runtime with ``random_init(quant="int8")``, which quantizes
        before the cast."""
        for module in ((self.trunk, self.decoder) if include_decoder
                       else (self.trunk,)):
            _require_float32_matmuls(module)
        trunk = cast_matmul_weights(_quantized(self.trunk, mode))
        decoder = self.decoder
        if include_decoder:
            decoder = cast_matmul_weights(_quantized(self.decoder, mode))
        return ESM3Runtime(trunk, decoder, self.sigma_embedder,
                           device=self.device)

    @torch.no_grad()
    def decode_batch(self, structure_tokens, sequences,
                     lengths=None) -> list[ESMProtein]:
        """Batched VQ-VAE decode.

        structure_tokens: (N, L+2) with BOS/EOS; sequences: list of N
        strings.  lengths: optional (N,) valid row lengths INCLUDING BOS/EOS
        — rows may be padded past their length; pad positions are masked out
        of decoder attention and stripped from the outputs.
        """
        toks = torch.as_tensor(np.asarray(structure_tokens), dtype=torch.long,
                               device=self.device)
        lens = (None if lengths is None else torch.as_tensor(
            np.asarray(lengths), dtype=torch.int32, device=self.device))
        out = self.decoder(toks, compute_ptm=False, lengths=lens)
        bb = out["bb_pred"][:, 1:].float().cpu().numpy()  # strip BOS
        prots = []
        for i, seq in enumerate(sequences):
            # a mismatched sequence/token pairing would otherwise silently
            # yield truncated or EOS/pad-contaminated coordinates
            row_len = (int(lengths[i]) if lengths is not None
                       else toks.shape[1])
            if len(seq) + 2 != row_len:
                raise ValueError(
                    f"decode_batch row {i}: sequence has {len(seq)} "
                    f"residues but the token row holds {row_len} positions "
                    f"incl. BOS/EOS (expected {len(seq) + 2})")
            p = protein_io.from_backbone(bb[i, :len(seq)], sequence=seq)
            coords = p.atom_positions.copy()
            coords[p.atom_mask < 0.5] = np.nan
            prots.append(ESMProtein(sequence=seq, coordinates=coords))
        return prots


def _require_float32_matmuls(module):
    """Raise if a Dense weight of ``module`` is held in a narrower dtype
    than float32 (see ``ESM3Runtime.quantize``)."""
    narrow = {m.weight.dtype for m in module.modules()
              if isinstance(m, Dense)} - {torch.float32}
    if narrow:
        raise ValueError(
            f"{type(module).__name__} holds its matmul weights in "
            f"{sorted(map(str, narrow))}: quantizing them would give int8 "
            "weights that differ from those the JAX package quantizes from "
            "float32; build the runtime with random_init(quant='int8')")


@torch.no_grad()
def _quantized(module, mode: str):
    """The ``quant=mode`` twin of a trunk or VQ decoder, on the module's
    device, holding ``quantize_trunk_params`` of its state dict."""
    if mode != "int8":
        raise ValueError(f"unknown quantization mode: {mode}")
    cfg = dataclasses.replace(module.cfg, quant="int8")
    if isinstance(cfg, ESM3Config):
        cfg = dataclasses.replace(cfg, qkv_backend="xla")
    with torch.device(next(module.parameters()).device):
        twin = type(module)(cfg)
    twin.load_state_dict(quantize_trunk_params(module.state_dict()),
                         strict=True)
    return twin.eval()
