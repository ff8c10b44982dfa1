"""The traffic is the same work for every seed: the seed changes pixels
and weights, never the shapes, sizes or order of the work."""
import numpy as np
import torch

from portbench.harness import serve_closed_loop as serve
from portbench.harness import train_pool as train

SEEDS = (2 ** 31 + 11, 2 ** 40 + 3)


def test_serving_traffic_is_the_same_work(serving):
    config, traffic = serving
    vols = [serve.make_volume(config, traffic, s, "cpu") for s in SEEDS]
    assert vols[0].shape == vols[1].shape == (max(traffic["sizes"]),
                                              config["img_size"],
                                              config["img_size"])
    assert vols[0].dtype == vols[1].dtype == np.int16
    assert not np.array_equal(vols[0], vols[1])
    done = dict.fromkeys(traffic["sizes"])
    samples = [serve.sample_sizes(done, traffic["sample"], s) for s in SEEDS]
    assert all(max(traffic["sizes"]) == s[0] and len(s) == traffic["sample"]
               for s in samples)


def test_training_pool_is_the_same_work(training):
    config, traffic = training
    pools = [train.make_pool(config, traffic, s, "cpu") for s in SEEDS]
    assert len(pools[0]) == len(pools[1]) == traffic["batches"]
    for a, b in zip(*pools):
        assert a.keys() == b.keys() == {"a", "b", "masks"}
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
        assert a["a"].shape == (traffic["batch"], config["img_size"],
                                config["img_size"], 1)
        assert a["masks"].shape[-1] == len(config["mask_types"])
        assert not torch.equal(a["a"], b["a"])
    # every row of the pool is a different slice
    rows = torch.cat([b["a"] for b in pools[0]]).flatten(1)
    assert len(torch.unique(rows, dim=0)) == len(rows)


def test_the_same_seed_gives_the_same_inputs(serving, training):
    config, traffic = serving
    assert np.array_equal(serve.make_volume(config, traffic, SEEDS[0], "cpu"),
                          serve.make_volume(config, traffic, SEEDS[0], "cpu"))
    config, traffic = training
    a, b = (train.make_pool(config, traffic, SEEDS[0], "cpu") for _ in "ab")
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
