"""``utils/tensor.py`` and ``utils/fixtures.py`` of the port against the
JAX package's (``tests/test_utils.py``'s cases, a nested tree and a
remainder chunk; the fixture paths with and without ``ESMDIFF_TARGETS``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.utils import fixtures as jfixtures
from esmdiff_tpu.utils import tensor as jtensor
from esmdiff_tpu_torch.utils import fixtures, tensor
from test_torch_support import to_np

ROOT = Path(__file__).resolve().parents[1]


def test_masked_mean_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((3, 5)).astype(np.float32)
    m = (rng.random((3, 5)) > 0.4).astype(np.float32)
    for dim in (None, 0, 1, -1):
        want = jtensor.masked_mean(jnp.asarray(m), jnp.asarray(v), axis=dim)
        got = tensor.masked_mean(torch.from_numpy(m), torch.from_numpy(v),
                                 dim=dim)
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6)
    got = tensor.masked_mean(torch.tensor([1.0, 1, 1, 0]),
                             torch.tensor([1.0, 2, 3, 100]))
    assert got.item() == pytest.approx(2.0, abs=1e-3)


def test_batched_gather_matches_jax():
    data = np.arange(24).reshape(2, 3, 4)
    inds = np.random.default_rng(1).integers(0, 4, (2, 3, 2))
    want = jtensor.batched_gather(jnp.asarray(data), jnp.asarray(inds), 2)
    got = tensor.batched_gather(torch.from_numpy(data),
                                torch.from_numpy(inds), dim=2)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    got = tensor.batched_gather(torch.arange(12).reshape(3, 4),
                                torch.tensor([[0, 3], [1, 2], [2, 0]]), 1)
    assert got.tolist() == [[0, 3], [5, 6], [10, 8]]


@pytest.mark.parametrize("n,chunk", [(23, 5), (20, 5), (4, 5)])
def test_chunk_apply_matches_jax_on_a_tree(n, chunk):
    """A dict holding a tensor and a (tensor, tensor) tuple: full chunks
    and the remainder, as JAX's; the chunks ``fn`` sees are JAX's."""
    rng = np.random.default_rng(2)
    x = {"a": rng.standard_normal((n, 3)).astype(np.float32),
         "b": (rng.standard_normal((n,)).astype(np.float32),
               rng.standard_normal((n, 2, 2)).astype(np.float32))}
    seen = {"jax": [], "port": []}

    def fn(t, who):
        seen[who].append(t["a"].shape[0])
        return {"y": t["a"] * 2 + t["b"][0][:, None],
                "z": (t["b"][1].sum(-1),)}

    want = jtensor.chunk_apply(
        lambda t: fn(t, "jax"),
        {"a": jnp.asarray(x["a"]), "b": tuple(map(jnp.asarray, x["b"]))},
        chunk)
    got = tensor.chunk_apply(
        lambda t: fn(t, "port"),
        {"a": torch.from_numpy(x["a"]),
         "b": tuple(map(torch.from_numpy, x["b"]))}, chunk)
    assert isinstance(got["z"], tuple)
    np.testing.assert_allclose(to_np(got["y"]), np.asarray(want["y"]),
                               rtol=1e-6)
    np.testing.assert_allclose(to_np(got["z"][0]), np.asarray(want["z"][0]),
                               rtol=1e-6)
    # JAX maps the full chunks in one traced call, then the remainder
    n_full = n // chunk * chunk
    assert seen["port"] == ([chunk] * (n_full // chunk) + [n - n_full]
                            * (n_full < n) if n > chunk else [n])


def test_distogram_and_pseudo_beta_match_jax():
    rng = np.random.default_rng(3)
    ca = (rng.standard_normal((2, 9, 3)) * 8).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(tensor.distogram(torch.from_numpy(ca))),
        np.asarray(jtensor.distogram(jnp.asarray(ca))))
    d = tensor.distogram(torch.tensor([[[0.0, 0, 0], [3.0, 0, 0],
                                        [30.0, 0, 0]]]))
    assert d.dtype == torch.int32 and d[0, 0, 0] == 0 and d[0, 0, 2] == 63
    pos = rng.standard_normal((4, 37, 3)).astype(np.float32)
    aatype = np.array([7, 0, 7, 3])
    np.testing.assert_array_equal(
        to_np(tensor.pseudo_beta(torch.from_numpy(pos),
                                 torch.from_numpy(aatype))),
        np.asarray(jtensor.pseudo_beta(jnp.asarray(pos),
                                       jnp.asarray(aatype))))


def test_fixtures(monkeypatch, tmp_path):
    """The repo's data/targets (JAX's too) without ESMDIFF_TARGETS, the
    variable's directory with it; with neither, a FileNotFoundError naming
    the variable (JAX falls back on a path outside the repo)."""
    monkeypatch.delenv("ESMDIFF_TARGETS", raising=False)
    assert fixtures.targets_root() == jfixtures.targets_root() == \
        ROOT / "data" / "targets"
    assert fixtures.bpti_pdb() == jfixtures.bpti_pdb()
    assert fixtures.bpti_pdb().is_file()
    monkeypatch.setenv("ESMDIFF_TARGETS", str(tmp_path))
    assert fixtures.targets_root() == jfixtures.targets_root() == tmp_path
    assert fixtures.bpti_pdb() == tmp_path / "bpti" / "bpti.pdb"
    monkeypatch.delenv("ESMDIFF_TARGETS")
    monkeypatch.setattr(fixtures, "_REPO_ROOT", tmp_path)
    with pytest.raises(FileNotFoundError, match="ESMDIFF_TARGETS"):
        fixtures.targets_root()
