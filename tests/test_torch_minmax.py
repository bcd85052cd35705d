"""The batched Min/Max descent and the MinMaxBatcher against the JAX package.

The same numpy planes and candidate masks go through the port's batched
descent (ops/bsi.py bsi_min_max_batched, its counts through the
bsi_sum_counts wrapper's plain version on the CPU), through K single
descents of the port, through its all-plain form, and through the JAX
package's vmapped _batched_min_max (pilosa_tpu/parallel/batcher.py:607).
Bits and counts are integers: the tolerance is 0.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.parallel.batcher import _batched_min_max
from pilosa_tpu_torch.ops import bsi, kernels
from pilosa_tpu_torch.parallel.batcher import MinMaxBatcher

S, W = 4, 256
DEPTHS = (1, 10, 21)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _inputs(seed: int, depth: int, k: int):
    """Random planes and k candidate masks: shard 1 of every mask is
    empty, mask 0 is sparse (a few columns), and mask k-1 repeats mask 0
    where k > 2 (a duplicated mask)."""
    rng = np.random.default_rng(seed)
    planes = _words(rng, depth, S, W)
    planes[:, 2, :8] = 0xFFFFFFFF  # all ones: Min must keep ones there
    masks = [_words(rng, S, W) for _ in range(k)]
    for m in masks:
        m[1] = 0
    masks[0][:] = 0
    masks[0][0, 3] = 0x10001
    masks[0][3, 100] = 0x80000000
    if k > 2:
        masks[-1] = masks[0].copy()
    return planes, masks


@pytest.mark.parametrize("is_min", (True, False), ids=("min", "max"))
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("k", (1, 2, 5))
def test_batched_descent_matches_single_and_jax(k, depth, is_min):
    planes, masks = _inputs(depth * 10 + k, depth, k)
    before = [p.copy() for p in (planes, *masks)]
    tplanes = _t(planes)
    tmasks = [_t(m) for m in masks]
    got = bsi.bsi_min_max_batched(tplanes, tmasks, is_min)
    assert got.dtype == torch.int32 and got.shape == (k, depth + 1, S)
    single = bsi.bsi_min_packed if is_min else bsi.bsi_max_packed
    for i, m in enumerate(tmasks):
        assert torch.equal(got[i], single(tplanes, m)), i
    assert torch.equal(got, bsi.bsi_min_max_batched_plain(tplanes, tmasks,
                                                          is_min))
    want = np.asarray(_batched_min_max(
        jnp.asarray(planes), tuple(jnp.asarray(m) for m in masks), is_min))
    np.testing.assert_array_equal(got.numpy(), want)
    # the empty shard attains nothing; the planes and masks are untouched
    assert not got[:, depth, 1].any()
    for a, b in zip(before, (planes, *masks)):
        np.testing.assert_array_equal(a, b)


def test_batched_descent_counts_come_from_bsi_sum_counts(monkeypatch):
    """D + 1 bsi_sum_counts calls for the whole batch, each over one
    contiguous plane view and the K candidates."""
    depth, k = 10, 6
    planes, masks = _inputs(3, depth, k)
    calls = []
    real = kernels.bsi_sum_counts

    def spy(p, filters, form=None):
        calls.append((tuple(p.shape), len(filters), p.is_contiguous()))
        return real(p, filters, form)

    monkeypatch.setattr(kernels, "bsi_sum_counts", spy)
    bsi.bsi_min_max_batched(_t(planes), [_t(m) for m in masks], True)
    assert calls == [((1, S, W), k, True)] * (depth + 1)


def test_minmax_batcher_dedups_and_answers_each(monkeypatch):
    """Concurrent Min descents over one slab coalesce; identical mask
    tensors are descended once; every answer equals the single descent."""
    depth = 10
    planes, masks = _inputs(5, depth, 4)
    tplanes = _t(planes)
    tmasks = [_t(m) for m in masks]
    seen = []
    real = bsi.bsi_min_max_batched

    def spy(p, cands, is_min):
        seen.append(len(cands))
        return real(p, cands, is_min)

    monkeypatch.setattr(bsi, "bsi_min_max_batched", spy)
    b = MinMaxBatcher(admission_s=0.05)
    order = [0, 1, 2, 1, 3, 0, 2, 2]  # masks by index: repeats share a tensor
    results = {}
    start = threading.Barrier(len(order))

    def worker(j):
        start.wait()
        results[j] = b.packed(tplanes, tmasks[order[j]], True)

    threads = [threading.Thread(target=worker, args=(j,))
               for j in range(len(order))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for j, i in enumerate(order):
        want = bsi.bsi_min_packed(tplanes, tmasks[i]).numpy().astype(np.int64)
        np.testing.assert_array_equal(results[j], want)
    snap = b.snapshot()
    assert snap["batched_queries"] == len(order)
    # each batch descends each distinct tensor once
    assert sum(seen) <= len(order) and snap["batches"] == len(seen)
    assert max(seen) <= len(set(order))
