"""Pure-Python tokenizers for the ESM3 token tracks (the port's copy of
``esmdiff_tpu/core/tokenizer.py``).

Replaces the reference's dependency on ``esm.tokenization.get_model_tokenizers``
(slm/models/net.py:19,356).  No torch, no HF — token tables only.
"""

from __future__ import annotations

import numpy as np

from . import constants as C


class SequenceTokenizer:
    """Amino-acid sequence tokenizer with ESM3's vocabulary and BOS/EOS
    conventions ('_' encodes the mask character, as used by the inpainting
    path, reference slm/models/utils.py:117-123)."""

    vocab = C.SEQUENCE_VOCAB
    bos_token_id = C.SEQUENCE_BOS_TOKEN
    eos_token_id = C.SEQUENCE_EOS_TOKEN
    pad_token_id = C.SEQUENCE_PAD_TOKEN
    mask_token_id = C.SEQUENCE_MASK_TOKEN
    chainbreak_token_id = C.SEQUENCE_CHAINBREAK_TOKEN

    def __init__(self):
        self._tok_to_id = {t: i for i, t in enumerate(self.vocab)}

    def encode(self, sequence: str, add_special_tokens: bool = True) -> np.ndarray:
        ids = [
            self.mask_token_id if ch == "_"
            else self._tok_to_id.get(ch, C.SEQUENCE_UNK_TOKEN)
            for ch in sequence
        ]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids, strip_special: bool = True) -> str:
        out = []
        for i in np.asarray(ids).tolist():
            tok = self.vocab[i] if 0 <= i < len(self.vocab) else "<unk>"
            if len(tok) == 1:
                out.append(tok)
            elif tok == "<mask>":
                out.append("_")
            elif not strip_special:
                out.append(tok)
        return "".join(out)


class StructureTokenizer:
    """Constants-only tokenizer for the VQ-VAE structure track (codes come from
    the structure encoder, not from text)."""

    bos_token_id = C.STRUCTURE_BOS_TOKEN
    eos_token_id = C.STRUCTURE_EOS_TOKEN
    pad_token_id = C.STRUCTURE_PAD_TOKEN
    mask_token_id = C.STRUCTURE_MASK_TOKEN
    chainbreak_token_id = C.STRUCTURE_CHAINBREAK_TOKEN
    vocab_size = C.STRUCTURE_VOCAB_SIZE
    codebook_size = C.VQVAE_CODEBOOK_SIZE

    @staticmethod
    def add_bos_eos(tokens: np.ndarray) -> np.ndarray:
        return np.concatenate([
            np.asarray([C.STRUCTURE_BOS_TOKEN], dtype=tokens.dtype),
            tokens,
            np.asarray([C.STRUCTURE_EOS_TOKEN], dtype=tokens.dtype),
        ])

    @staticmethod
    def strip_bos_eos(tokens: np.ndarray) -> np.ndarray:
        return tokens[..., 1:-1]


def add_bos_eos_sequence(tokens: np.ndarray) -> np.ndarray:
    return np.concatenate([
        np.asarray([C.SEQUENCE_BOS_TOKEN], dtype=tokens.dtype),
        tokens,
        np.asarray([C.SEQUENCE_EOS_TOKEN], dtype=tokens.dtype),
    ])
