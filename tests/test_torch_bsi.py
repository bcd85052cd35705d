"""The port's BSI functions against the JAX package, function by function.

The same numpy planes go through pilosa_tpu (Pallas in interpret mode, as
tests/test_pallas.py runs it, and the XLA forms of ops/bsi.py) and through
pilosa_tpu_torch on the CPU, where the kernel wrappers take their plain
versions. Masks and counts are integers: the tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.ops import bsi as jbsi
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu.parallel.batcher import _batched_plane_sums
from pilosa_tpu_torch.ops import bsi
from pilosa_tpu_torch.ops import kernels

S, W = 3, 1024  # small shapes keep interpret-mode Pallas quick
DEPTHS = (1, 10, 33)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _slab(rng, depth: int, s: int = S, w: int = W, pred: int = 0):
    """Random planes with all-ones and lone sign-bit words, and a not-null
    row with the same edge words; words 20:30 hold exactly `pred` in every
    column (so eq/lte/gte match there) and words 30:34 pred + 1 where it
    fits."""
    planes = _words(rng, depth, s, w)
    planes[..., :7] = 0xFFFFFFFF
    planes[..., 7:13] = 0x80000000
    for i in range(depth):
        planes[i, :, 20:30] = 0xFFFFFFFF if (pred >> i) & 1 else 0
        if pred + 1 < 1 << depth:
            planes[i, :, 30:34] = 0xFFFFFFFF if ((pred + 1) >> i) & 1 else 0
    exists = _words(rng, s, w)
    exists[:, :5] = 0xFFFFFFFF
    exists[:, 5:9] = 0x80000000
    exists[:, 20:34] = 0xFFFFFFFF
    exists[-1, 40:60] = 0
    return planes, exists


def _preds(rng, depth: int) -> list:
    return [0, (1 << depth) - 1, int(rng.integers(0, 1 << min(depth, 62)))]


# -- bsi_compare ------------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("op", kernels.BSI_OPS)
def test_bsi_compare_matches_pallas_and_xla(op, depth):
    rng = np.random.default_rng(depth)
    for pred in _preds(rng, depth):
        planes, exists = _slab(rng, depth, pred=pred)
        bits = jbsi.value_to_bits(pred, depth)
        got = kernels.bsi_compare(_t(planes), _t(exists), bits, op)
        assert got.dtype == torch.int32 and got.shape == (S, W)
        want = np.asarray(pk.bsi_compare(jnp.asarray(planes),
                                         jnp.asarray(exists),
                                         jnp.asarray(bits), op))
        np.testing.assert_array_equal(_u(got), want, err_msg=f"{op} {pred}")
        xla = np.asarray(jbsi.compare(jnp.asarray(planes), jnp.asarray(exists),
                                      bits, op))
        np.testing.assert_array_equal(_u(got), xla)
        # the port's ops/bsi.compare takes the same route
        np.testing.assert_array_equal(
            _u(bsi.compare(_t(planes), _t(exists), bits, op)), want)


def test_bsi_compare_plain_is_the_wrapper_on_cpu():
    rng = np.random.default_rng(5)
    planes, exists = _slab(rng, 10, pred=77)
    bits = bsi.value_to_bits(77, 10)
    for op in kernels.BSI_OPS:
        assert torch.equal(
            kernels.bsi_compare(_t(planes), _t(exists), bits, op),
            kernels.bsi_compare_plain(_t(planes), _t(exists), bits, op))


def test_bsi_compare_rejects_bad_input():
    planes, exists = _t(np.zeros((2, 3, 8), np.uint32)), _t(np.zeros((3, 8), np.uint32))
    with pytest.raises(ValueError, match="unknown comparison op"):
        kernels.bsi_compare(planes, exists, [0, 0], "between")
    with pytest.raises(ValueError, match="predicate bits"):
        kernels.bsi_compare(planes, exists, [0, 0, 0], "lt")
    with pytest.raises(ValueError, match="predicate bits"):
        bsi.compare(planes, exists, [0], "lt")
    with pytest.raises(ValueError, match="does not match"):
        kernels.bsi_compare(planes, exists[:2], [0, 0], "lt")
    with pytest.raises(ValueError, match="depth of at least 1"):
        kernels.bsi_compare(planes[:0], exists, [], "lt")
    with pytest.raises(TypeError):
        kernels.bsi_compare(planes.to(torch.int64), exists, [0, 0], "lt")


# -- bsi_sum_counts ---------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
def test_bsi_sum_counts_matches_pallas_and_xla(depth):
    rng = np.random.default_rng(100 + depth)
    planes, filt = _slab(rng, depth)
    got = kernels.bsi_sum_counts(_t(planes), _t(filt))
    assert got.dtype == torch.int32 and got.shape == (depth + 1, S)
    want = np.asarray(pk.bsi_sum_counts(jnp.asarray(planes), jnp.asarray(filt)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbsi.sum_counts(jnp.asarray(planes),
                                                jnp.asarray(filt))))


@pytest.mark.parametrize("s,w", [(3, W), (2017, 32)])
@pytest.mark.parametrize("k", (1, 3, 33))
def test_bsi_sum_counts_k_filters_match_batched_plane_sums(k, s, w):
    """The batcher's K-filter form: per-shard counts summed over shards
    equal the JAX batcher's per-chunk partials summed over chunks (two
    2016-shard chunks at S = 2017; K = 33 is one past the staged kernel's
    32-filter group)."""
    rng = np.random.default_rng(200 + k + s)
    planes, _ = _slab(rng, 10, s, w)
    filts = [_slab(rng, 1, s, w)[1] for _ in range(k)]
    got = kernels.bsi_sum_counts(_t(planes), [_t(f) for f in filts])
    assert got.shape == (k, 11, s)
    want = np.asarray(_batched_plane_sums(
        jnp.asarray(planes), tuple(jnp.asarray(f) for f in filts)))
    assert want.shape[-1] == -(-s // 2016)
    np.testing.assert_array_equal(got.numpy().astype(np.int64).sum(axis=-1),
                                  want.astype(np.int64).sum(axis=-1))
    # K = 1 in list form is the single-filter layout with a leading axis
    np.testing.assert_array_equal(
        got[0].numpy(), kernels.bsi_sum_counts(_t(planes), _t(filts[0])).numpy())


def test_bsi_sum_counts_rejects_bad_input():
    planes = _t(np.zeros((2, 3, 8), np.uint32))
    with pytest.raises(ValueError, match="no filters"):
        kernels.bsi_sum_counts(planes, [])
    with pytest.raises(ValueError, match="does not match"):
        kernels.bsi_sum_counts(planes, _t(np.zeros((3, 4), np.uint32)))
    with pytest.raises(ValueError, match=r"\[D, S, W\]"):
        kernels.bsi_sum_counts(planes[0], _t(np.zeros((3, 8), np.uint32)))


# -- Min / Max descents -------------------------------------------------------------


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("is_min", [True, False])
def test_min_max_descents_match_jax(is_min, depth):
    rng = np.random.default_rng(300 + depth)
    planes, cand = _slab(rng, depth, s=4, w=256)
    cand[1] &= _words(rng, 256) & _words(rng, 256)  # sparser shard
    cand[2] = 0  # a shard with no candidate
    cand[3] = 0
    cand[3, 100] = 0x00010000  # a shard with one candidate
    port = bsi.bsi_min_packed if is_min else bsi.bsi_max_packed
    ref = jbsi.bsi_min_packed if is_min else jbsi.bsi_max_packed
    got = port(_t(planes), _t(cand))
    assert got.dtype == torch.int32 and got.shape == (depth + 1, 4)
    want = np.asarray(ref(jnp.asarray(planes), jnp.asarray(cand)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_descents_launch_no_kernel_on_cpu():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(7)
    planes, cand = _slab(rng, 4, s=2, w=64)
    bsi.bsi_min_packed(_t(planes), _t(cand))
    bsi.bsi_max_packed(_t(planes), _t(cand))
    kernels.bsi_sum_counts(_t(planes), [_t(cand)])
    kernels.bsi_compare(_t(planes), _t(cand), [1, 0, 1, 0], "gt")
    assert set(kernels.launch_counts().values()) == {0}


# -- value / bit helpers --------------------------------------------------------------


@pytest.mark.parametrize("value,depth", [(0, 1), (1, 1), (5, 3), (1023, 10),
                                         (2**33 - 1, 33), (2**62 + 12345, 64)])
def test_value_bit_helpers_match_jax(value, depth):
    bits = bsi.value_to_bits(value, depth)
    np.testing.assert_array_equal(bits, jbsi.value_to_bits(value, depth))
    assert bsi.bits_to_value(bits) == jbsi.bits_to_value(bits) == value
    counts = np.arange(depth, dtype=np.int64) * 1_000_003
    assert bsi.counts_to_sum(counts) == jbsi.counts_to_sum(counts)
    with pytest.raises(ValueError):
        bsi.value_to_bits(-1, depth)
