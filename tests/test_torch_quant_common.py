"""``lotus_tpu_torch.ops.quant`` / ``ops.common`` held bit for bit to the JAX
reference on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lotus_tpu.ops import common as jcommon
from lotus_tpu.ops import quant as jquant
from lotus_tpu_torch.ops import common as tcommon
from lotus_tpu_torch.ops import quant as tquant


def _rows(seed, n=257, d=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[3] = 0.0  # zero row: scale 0, all-zero codes
    x[5, :] = np.float32(0.5)  # exact ties at the rounding half-way point after scaling
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bitwise(seed):
    x = _rows(seed)
    jq, js = jquant.quantize_rows(jnp.asarray(x))
    tq, ts = tquant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))


def test_int4_refinement_pack_unpack_bitwise():
    x = _rows(2) * 0.01
    jp, js = jquant.quantize_refinement_int4(jnp.asarray(x))
    tp, ts = tquant.quantize_refinement_int4(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(tquant.unpack_int4(tp).numpy(), np.asarray(jquant.unpack_int4(jp)))
    # Even dims sit in the low nibble, and every int4 code round-trips.
    codes = np.arange(-8, 8, dtype=np.int8).reshape(1, 16)
    packed = ((codes[:, 0::2] & 0xF) | ((codes[:, 1::2] & 0xF) << 4)).astype(np.int8)
    np.testing.assert_array_equal(tquant.unpack_int4(torch.from_numpy(packed)).numpy(), codes)


def test_int8_scores_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (17, 768), dtype=np.int8)
    b = rng.integers(-127, 128, (33, 768), dtype=np.int8)
    qs, bs = rng.random(17).astype(np.float32), rng.random(33).astype(np.float32)
    ref = jquant.int8_scores(jnp.asarray(a), jnp.asarray(qs), jnp.asarray(b), jnp.asarray(bs))
    got = tquant.int8_scores(torch.from_numpy(a), torch.from_numpy(qs), torch.from_numpy(b), torch.from_numpy(bs))
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(ref).view(np.int32))
    wide = tquant.exact_int8_dot(torch.from_numpy(np.tile(a, 2)), torch.from_numpy(np.tile(b, 2)))
    np.testing.assert_array_equal(wide.numpy(), 2 * (a.astype(np.int64) @ b.T.astype(np.int64)))


@pytest.mark.parametrize("with_aux", [False, True])
def test_dedup_topk_bitwise(with_aux):
    rng = np.random.default_rng(4)
    b, m, k = 6, 24, 8
    scores = -np.sort(-rng.permutation(b * m).reshape(b, m).astype(np.float32), axis=1)
    ids = rng.integers(0, 10, (b, m)).astype(np.int32)  # many duplicate ids
    ids[0, -3:] = tcommon.NO_HIT
    aux = rng.integers(0, 1000, (b, m)).astype(np.int32)
    ja = jnp.asarray(aux) if with_aux else None
    ta = torch.from_numpy(aux) if with_aux else None
    ref = jcommon.dedup_topk(jnp.asarray(scores), jnp.asarray(ids), k, aux=ja)
    got = tcommon.dedup_topk(torch.from_numpy(scores), torch.from_numpy(ids), k, aux=ta)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # k beyond the pool pads with MASK_SCORE / NO_HIT.
    ref = jcommon.dedup_topk(jnp.asarray(scores[:, :4]), jnp.asarray(ids[:, :4]), 6)
    got = tcommon.dedup_topk(torch.from_numpy(scores[:, :4]), torch.from_numpy(ids[:, :4]), 6)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
def test_distance_similarity_and_normalize(metric):
    x = _rows(5)
    np.testing.assert_array_equal(
        tcommon.as_distance(torch.from_numpy(x), metric).numpy(), np.asarray(jcommon.as_distance(jnp.asarray(x), metric))
    )
    np.testing.assert_array_equal(
        tcommon.as_similarity(torch.from_numpy(x), metric).numpy(),
        np.asarray(jcommon.as_similarity(jnp.asarray(x), metric)),
    )
    np.testing.assert_allclose(
        tcommon.l2_normalize(torch.from_numpy(x)).numpy(), np.asarray(jcommon.l2_normalize(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7,
    )
    assert tcommon.NO_HIT == jcommon.NO_HIT and tcommon.MASK_SCORE == jcommon.MASK_SCORE
    assert [tcommon.cdiv(a, 7) for a in range(20)] == [jcommon.cdiv(a, 7) for a in range(20)]
    assert [tcommon.round_up(a, 8) for a in range(20)] == [jcommon.round_up(a, 8) for a in range(20)]
