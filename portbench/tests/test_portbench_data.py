"""Inputs are a function of the seed alone."""

import numpy as np
import torch

from portbench import data

SPEC = {"generator": "clustered", "centers": 16, "center_scale": 2.0,
        "row_noise": 1.0, "normalize": True, "query_noise": 0.5}


def made(seed):
    corpus, centers = data.clustered(SPEC, 3000, 32, seed, "cpu")
    return corpus.numpy(), data.queries(SPEC, centers, 50, seed, data.POOL)


def test_same_seed_same_inputs():
    for seed in (0, 7, 2 ** 31 + 11, 2 ** 40 + 3):
        a, qa = made(seed)
        b, qb = made(seed)
        assert np.array_equal(a, b) and np.array_equal(qa, qb)


def test_other_seeds_other_inputs_of_the_same_sizes():
    a, qa = made(2 ** 31 + 11)
    b, qb = made(2 ** 31 + 12)
    assert a.shape == b.shape and qa.shape == qb.shape
    assert not np.array_equal(a, b) and not np.array_equal(qa, qb)


def test_every_seed_turns_the_same_geometry():
    """The seed rotates one fixed draw: distances between rows, and so an
    index's partition, are the same for every seed."""
    a, _ = made(2 ** 31 + 11)
    b, _ = made(2 ** 40 + 3)
    assert not np.allclose(a, b)
    np.testing.assert_allclose(a[:200] @ a[:200].T, b[:200] @ b[:200].T,
                               atol=1e-5)
    r = data.rotation(32, 9, "cpu")
    np.testing.assert_allclose((r.T @ r).numpy(), np.eye(32), atol=1e-6)


def test_rows_are_normalised_and_streams_differ():
    corpus, centers = data.clustered(SPEC, 3000, 32, 5, "cpu")
    assert torch.allclose(torch.linalg.norm(corpus, dim=1),
                          torch.ones(3000), atol=1e-5)
    seeds = {data.stream_seed(5, s) for s in range(6)}
    assert len(seeds) == 6 and all(0 <= s < 2 ** 63 for s in seeds)
    assert not np.array_equal(data.queries(SPEC, centers, 8, 5, data.POOL),
                              data.queries(SPEC, centers, 8, 5, data.EVAL))


def test_ids_are_the_rows_names():
    assert data.ids(3).tolist() == ["v0", "v1", "v2"]
