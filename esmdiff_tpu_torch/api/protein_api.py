"""ESMProtein-style state API over the port's models (port of
``esmdiff_tpu/api/protein_api.py``): proteins and their token tensors, and
the runtime that bundles the trunk, the VQ-VAE encoder and decoder and the
sigma embedder behind the encode / decode surface."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.core import residue_constants as rc
from esmdiff_tpu_torch.core.tokenizer import (SequenceTokenizer,
                                              StructureTokenizer)
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.esm3 import ESM3, ESM3Config
from esmdiff_tpu_torch.models.vqvae import (DecoderConfig, EncoderConfig,
                                            StructureTokenDecoder,
                                            StructureTokenEncoder)
from esmdiff_tpu_torch.nn.layers import (Dense, TimestepEmbedder,
                                         cast_matmul_weights, init_params)
from esmdiff_tpu_torch.ops.quant import quantize_trunk_params
from esmdiff_tpu_torch.utils import tracing


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

    @classmethod
    def from_npz(cls, path: str | Path):
        """Load a curation-pipeline example (the JAX package's
        ``cli/preprocess.py`` npz layout: sequence, atom_positions,
        atom_mask [, chain_index]).

        A multi-chain example carries a per-residue ``chain_index``; a '|'
        chainbreak is inserted in the sequence at each chain transition
        with a NaN coordinate row, so the encode path emits chainbreak
        tokens on both tracks."""
        with np.load(path) as z:
            coords = z["atom_positions"].astype(np.float32).copy()
            coords[z["atom_mask"] < 0.5] = np.nan
            seq = str(z["sequence"])
            chain_index = (z["chain_index"] if "chain_index" in z.files
                           else None)
        if chain_index is not None:
            breaks = np.where(np.diff(chain_index) != 0)[0]
            if len(breaks):
                coords = np.insert(coords, breaks + 1, np.nan, axis=0)
                chars = list(seq)
                for b in reversed(breaks.tolist()):
                    chars.insert(b + 1, "|")
                seq = "".join(chars)
        return cls(sequence=seq, coordinates=coords)

    def to_pdb(self, path: str | Path):
        protein_io.to_pdb_file(self.to_protein(), path)

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


@dataclasses.dataclass
class ESMProteinTensor:
    """Tokenized protein (BOS/EOS included on both tracks)."""

    sequence: np.ndarray                      # (L+2,) int32
    structure: Optional[np.ndarray] = None    # (L+2,) int32
    coordinates: Optional[np.ndarray] = None  # (L, 37, 3)


class ESM3Runtime:
    """Bundles the trunk, the VQ decoder, the sigma embedder and the
    structure encoder (modules holding their parameters, all on
    ``device``) and exposes the encode / decode surface the samplers and
    the CLIs use.  Without an encoder, ``encode`` of a protein with
    coordinates raises."""

    def __init__(self, trunk: ESM3, decoder: StructureTokenDecoder,
                 sigma_embedder: Optional[TimestepEmbedder] = None,
                 device=None,
                 encoder: Optional[StructureTokenEncoder] = None):
        self.device = resolve_device(device)
        self.trunk = trunk.to(self.device).eval()
        self.decoder = decoder.to(self.device).eval()
        self.sigma_embedder = (None if sigma_embedder is None
                               else sigma_embedder.to(self.device).eval())
        self.encoder = (None if encoder is None
                        else encoder.to(self.device).eval())
        self.seq_tokenizer = SequenceTokenizer()

    @classmethod
    def random_init(cls, seed: int = 0,
                    trunk_cfg: Optional[ESM3Config] = None,
                    decoder_cfg: Optional[DecoderConfig] = None,
                    device=None, quant: str = "none",
                    encoder_cfg: Optional[EncoderConfig] = None,
                    ) -> "ESM3Runtime":
        """Random weights from ``seed`` — for tests, benchmarks and dev.

        The modules are built and initialised on ``device``, so the 1.4B
        trunk never initialises on the host; matmul weights are then stored
        in each module's compute dtype (see ``cast_matmul_weights``).
        quant: "int8" quantizes the trunk (``quantize``) from its float32
        weights, before that cast, as the JAX package quantizes its float32
        params; the other weights are those of ``quant="none"``.  The
        encoder (``encoder_cfg``, default full width) is initialised last,
        so it leaves the other modules' weights as they were without it;
        its codebook is N(0, 1), as in JAX."""
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
            encoder = StructureTokenEncoder(encoder_cfg or EncoderConfig())
        for m in (trunk, decoder, sig, encoder):
            init_params(m, gen)
        with torch.no_grad():
            encoder.codebook.normal_(0.0, 1.0, generator=gen)
        if quant != "none":
            trunk = _quantized(trunk, quant)
        for m in (trunk, decoder, sig, encoder):
            cast_matmul_weights(m)
        return cls(trunk, decoder, sig, device=dev, encoder=encoder)

    def quantize(self, mode: str = "int8",
                 include_decoder: bool = False) -> "ESM3Runtime":
        """A runtime whose trunk runs W8A8 int8 projections (ops/quant.py);
        attention cores, LayerNorms, embeddings and heads keep their dtype.
        The sigma embedder and the encoder (float32, as in JAX) are
        shared, and the decoder too unless
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
                           device=self.device, encoder=self.encoder)

    @torch.no_grad()
    def encode(self, prot: ESMProtein) -> ESMProteinTensor:
        """Sequence tokens, and structure tokens from the coordinates when
        the protein has them, both with BOS/EOS.  Non-finite coordinates
        mark unknown residues (the inpainting path sets the residues to
        generate to inf), which get STRUCTURE_MASK_TOKEN; structure
        chainbreaks are tied to the sequence's."""
        seq_tokens = self.seq_tokenizer.encode(prot.sequence)
        structure = None
        if prot.coordinates is not None:
            if self.encoder is None:
                raise ValueError("this runtime has no structure encoder")
            bb = torch.as_tensor(prot.backbone()[None], dtype=torch.float32,
                                 device=self.device)
            tokens, _, _ = self.encoder(bb)
            structure = StructureTokenizer.add_bos_eos(
                tokens[0].cpu().numpy().astype(np.int32))
            structure = np.where(
                seq_tokens == C.SEQUENCE_CHAINBREAK_TOKEN,
                np.int32(C.STRUCTURE_CHAINBREAK_TOKEN), structure)
        return ESMProteinTensor(sequence=seq_tokens, structure=structure,
                                coordinates=prot.coordinates)

    def decode(self, pt: ESMProteinTensor) -> ESMProtein:
        """Structure tokens -> backbone -> atom37 protein with inferred
        oxygen."""
        return self.decode_batch(
            pt.structure[None], [self.seq_tokenizer.decode(pt.sequence)])[0]

    def encode_decode(self, pdb_path: str | Path
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize a structure and decode it back: (coords, coords_pred),
        both (L, 37, 3), the round-trip fidelity probe."""
        prot = ESMProtein.from_pdb(pdb_path)
        pred = self.decode(self.encode(prot))
        return prot.coordinates, pred.coordinates

    @torch.no_grad()
    def decode_batch(self, structure_tokens, sequences,
                     lengths=None) -> list[ESMProtein]:
        """Batched VQ-VAE decode.

        structure_tokens: (N, L+2) with BOS/EOS; sequences: list of N
        strings.  lengths: optional (N,) valid row lengths INCLUDING BOS/EOS
        — rows may be padded past their length; pad positions are masked out
        of decoder attention and stripped from the outputs.
        Spans: ``decode.device`` (the decoder and the backbone's copy to
        the host), then ``decode.host`` (the rows' atoms, on the host).
        """
        with tracing.span("decode.device"):
            toks = torch.as_tensor(np.asarray(structure_tokens),
                                   dtype=torch.long, device=self.device)
            lens = (None if lengths is None else torch.as_tensor(
                np.asarray(lengths), dtype=torch.int32, device=self.device))
            out = self.decoder(toks, compute_ptm=False, lengths=lens)
            bb = out["bb_pred"][:, 1:].float().cpu().numpy()  # strip BOS
        prots = []
        with tracing.span("decode.host"):
            for i, seq in enumerate(sequences):
                # a mismatched sequence/token pairing would otherwise
                # silently yield truncated or EOS/pad-contaminated
                # coordinates
                row_len = (int(lengths[i]) if lengths is not None
                           else toks.shape[1])
                if len(seq) + 2 != row_len:
                    raise ValueError(
                        f"decode_batch row {i}: sequence has {len(seq)} "
                        f"residues but the token row holds {row_len} "
                        f"positions incl. BOS/EOS (expected {len(seq) + 2})")
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
