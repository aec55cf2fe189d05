"""Token-space constants for the ESM3 latent space.

The PyTorch port keeps its own copy of ``esmdiff_tpu/core/constants.py`` so
that it imports nothing of the JAX package.  Reimplementation of the constant
surface the reference consumes from ``esm.utils.constants.esm3`` (see
reference slm/models/net.py:12, slm/models/model.py:380
"vocab_size = 4101 = VQVAE_CODEBOOK_SIZE + 5 special tokens", and
configs/model/default.yaml:39 "pad_token_id: 4099").
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Sequence (amino-acid) track.
#
# ESM3's sequence vocabulary: 4 control tokens, 25 residue letters (incl.
# ambiguity codes), '.', '-', chainbreak '|', and '<mask>'.  33 entries; the
# embedding table in the trunk is padded to 64 rows.
# ---------------------------------------------------------------------------
SEQUENCE_VOCAB: list[str] = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K",
    "Q", "N", "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z",
    "O", ".", "-", "|", "<mask>",
]
SEQUENCE_VOCAB_SIZE = len(SEQUENCE_VOCAB)  # 33
SEQUENCE_EMBED_SIZE = 64  # embedding table padded to 64 rows

SEQUENCE_BOS_TOKEN = 0   # "<cls>"
SEQUENCE_PAD_TOKEN = 1
SEQUENCE_EOS_TOKEN = 2
SEQUENCE_UNK_TOKEN = 3
SEQUENCE_CHAINBREAK_TOKEN = SEQUENCE_VOCAB.index("|")   # 31
SEQUENCE_MASK_TOKEN = SEQUENCE_VOCAB.index("<mask>")    # 32

# ---------------------------------------------------------------------------
# Structure (VQ-VAE) track.  Codebook of 4096 learned codes + 5 specials.
# Reference: slm/models/model.py:380-383, sample_esmdiff.py:46-53.
# ---------------------------------------------------------------------------
VQVAE_CODEBOOK_SIZE = 4096
STRUCTURE_MASK_TOKEN = 4096
STRUCTURE_EOS_TOKEN = 4097
STRUCTURE_BOS_TOKEN = 4098
STRUCTURE_PAD_TOKEN = 4099
STRUCTURE_CHAINBREAK_TOKEN = 4100
STRUCTURE_VOCAB_SIZE = VQVAE_CODEBOOK_SIZE + 5  # 4101
STRUCTURE_NUM_SPECIAL_TOKENS = 5

# ---------------------------------------------------------------------------
# Auxiliary conditioning tracks.  Only their pad defaults matter for the
# conformation-generation task (reference slm/models/net.py:410-431), but the
# vocab sizes fix the embedding-table shapes for checkpoint conversion.
# ---------------------------------------------------------------------------
SS8_PAD_TOKEN = 0
SS8_VOCAB_SIZE = 11          # 8 classes + pad/motif/unk

SASA_PAD_TOKEN = 0
SASA_VOCAB_SIZE = 19         # 16 bins + pad/motif/unk

INTERPRO_PAD_TOKEN = 0
FUNCTION_TOKEN_DEPTH = 8     # function track is (L, 8) tokens
FUNCTION_VOCAB_SIZE = 260

RESIDUE_PAD_TOKEN = 0
RESIDUE_ANNOTATION_DEPTH = 16   # residue-annotation track is (L, 16)
RESIDUE_ANNOTATION_VOCAB_SIZE = 1481

# Model geometry of ESM3-open-small (reference slm/models/net.py:33,325-345).
ESM3_D_MODEL = 1536
ESM3_N_HEADS = 24
ESM3_V_HEADS = 256
ESM3_N_LAYERS = 48

# VQ-VAE decoder embedding width (reference slm/models/net.py:102,263).
VQVAE_DECODER_D_MODEL = 1280
