"""The port's sequence-parallel ring attention (``parallel/ring.py``) on 4
gloo ranks (CPU): each rank's slice of the output against the JAX
package's ``ring_attention`` on a 4-device ``seq`` mesh and against the
plain attention, with prefix ``lengths`` (a row padded past 37, so the
keys of the last two blocks are masked on global positions) and without
(2e-5 absolute, 1e-5 relative, JAX's own tolerance); one process, no
group, equals the plain attention; a length that does not divide by the
ring raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from esmdiff_tpu.nn.attention import dot_product_attention
from esmdiff_tpu.parallel import ring as jring
from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths
from esmdiff_tpu_torch.parallel import ring
from torch_ranks import run_ranks

torch.set_num_threads(2)

B, L, H, Dh = 2, 64, 2, 16
TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, L, H, Dh).astype(np.float32) for _ in range(3))
    return q, k, v, np.array([64, 37], np.int32)


@pytest.fixture(scope="module")
def jax_ring(inputs):
    q, k, v, lengths = inputs
    mesh = Mesh(np.asarray(jax.devices()[:4]), (jring.SEQ_AXIS,))
    spec = NamedSharding(mesh, P(None, jring.SEQ_AXIS, None, None))
    qs, ks, vs = (jax.device_put(jnp.asarray(x), spec) for x in (q, k, v))
    return (np.asarray(jring.ring_attention(qs, ks, vs, jnp.asarray(lengths),
                                            mesh=mesh)),
            np.asarray(jring.ring_attention(qs, ks, vs, mesh=mesh)))


def test_four_ranks_match_jax_and_plain(inputs, jax_ring, tmp_path):
    q, k, v, lengths = inputs
    torch.save({"q": torch.from_numpy(q), "k": torch.from_numpy(k),
                "v": torch.from_numpy(v),
                "lengths": torch.from_numpy(lengths)}, tmp_path / "x.pt")
    ranks = run_ranks(tmp_path, 4, [dict(name="ring", kind="ring",
                                         inputs=str(tmp_path / "x.pt"))])
    got = np.concatenate([r["ring"]["out"].numpy() for r in ranks], axis=1)
    full = np.concatenate([r["ring"]["full"].numpy() for r in ranks], axis=1)
    want, want_full = jax_ring
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(full, want_full, **TOL)
    plain = np.asarray(dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=jnp.asarray(lengths), backend="xla"))
    np.testing.assert_allclose(got, plain, **TOL)
    assert all("not divisible by the ring size 4" in r["ring"]["raised"]
               for r in ranks)


def test_one_process_is_the_plain_attention(inputs):
    q, k, v, lengths = (torch.from_numpy(x) for x in inputs)
    got = ring.ring_attention(q, k, v, lengths)
    want = plain_attention_with_lengths(q, k, v, lengths)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert torch.equal(ring.shard_sequence(q), q)
