"""The traffic generators: the same seed gives the same inputs; every seed
gives the same sizes and arrivals, in its own order; seeds past 32 bits."""
import json
from pathlib import Path

import numpy as np
import torch

from benchmark import harness, weights

BENCH = Path(__file__).resolve().parents[1]
BIG = 2**31 + 12345


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def driver(name):
    return harness.load_module(BENCH / "drivers" / f"{name}.py", f"t_{name}")


def test_train_pool_is_the_seeds():
    train = driver("train")
    t = dict(mix("train-s919"), batch=2, image_size=48, pool=3)
    a, b = train.make_pool(t, BIG), train.make_pool(t, BIG)
    c = train.make_pool(t, BIG + 1)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["image"], c[0]["image"])
    counts = lambda pool: sorted(int(n) for p in pool
                                 for n in p["instance_valid"].sum(1))
    assert counts(a) == counts(c)
    lo, hi = t["valid_counts"]
    assert min(counts(a)) >= lo and max(counts(a)) <= hi
    assert all(p["semantic_mask"].max() == t["ignore_index"] for p in a)


def test_serve_arrivals_are_every_seeds_in_its_own_order():
    sv = driver("serve")
    a, b = sv.arrival_gaps(500, 300.0, BIG), sv.arrival_gaps(500, 300.0, 1)
    assert np.array_equal(a, sv.arrival_gaps(500, 300.0, BIG))
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert abs(a.mean() - 1 / 300.0) < 0.05 / 300.0


def test_weights_are_the_seeds():
    cfg = dict(width=64, encoder_layers=1, encoder_heads=2, patch_size=16,
               text_dim=32, input_resolution=32, n_queries=4,
               n_decoder_layers=1, n_heads=2)
    a = weights.make_weights(cfg, BIG, "cpu")
    b = weights.make_weights(cfg, BIG, "cpu")
    c = weights.make_weights(cfg, BIG + 1, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert c["query_embed"].dtype == torch.bfloat16
    assert c["decoder.norm.weight"].dtype == torch.float32
    assert not torch.equal(a["query_embed"], c["query_embed"].float())
    t = weights.text_embeddings(5, 32, BIG, "cpu")
    assert torch.allclose(t.norm(dim=1), torch.ones(5))
