"""The traffic generator: seeded, deterministic, the same sizes for every
seed in another order."""

import numpy as np

import tiny  # noqa: F401  (puts bench/ on the path)
import harness
import traffic as T


def _traffic(name):
    return harness.cell(name)["traffic"]


def test_same_seed_same_requests():
    tr = _traffic("olmoe-chat")
    a = T.requests(tr, 2**31 + 17, 50304, 70)
    b = T.requests(tr, 2**31 + 17, 50304, 70)
    assert [r.due for r in a] == [r.due for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.max_new for r in a] == [r.max_new for r in b]


def test_seeds_share_sizes_in_another_order():
    tr = _traffic("olmoe-chat")
    n = tr["block"] * 3
    a = T.requests(tr, 1, 50304, n)
    b = T.requests(tr, 2, 50304, n)
    sizes = lambda rs: sorted((len(r.prompt), r.max_new) for r in rs)  # noqa: E731
    assert sizes(a) == sizes(b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    # whole blocks of gaps: the same arrival times at every block's end
    blk = tr["block"]
    assert abs(a[blk - 1].due - b[blk - 1].due) < 1e-9
    assert abs(a[blk - 1].due - blk / tr["rate_per_s"]) < 1e-9


def test_lengths_within_clips_and_batch_due_at_zero():
    tr = _traffic("stablelm-batch")
    rs = T.requests(tr, 3, 100352, 100)
    assert all(r.due == 0 for r in rs)
    p, o = tr["prompt"], tr["output"]
    assert all(p["min"] <= len(r.prompt) <= p["max"] for r in rs)
    assert all(o["min"] <= r.max_new <= o["max"] for r in rs)
    assert all(len(r.prompt) + r.max_new <= tr["engine"]["max_seq"]
               for r in rs)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 100352 for r in rs)


def test_prompt_lengths_are_every_length_sent():
    tr = _traffic("olmoe-chat")
    sent = {len(r.prompt) for r in T.requests(tr, 9, 50304, 200)}
    assert sent == set(T.prompt_lengths(tr))


def test_train_batches_seeded_rows_differ():
    tr = _traffic("olmoe-train")
    a = T.train_batch(tr, 7, 0, 50304)
    assert np.array_equal(a["tokens"], T.train_batch(tr, 7, 0, 50304)["tokens"])
    b = T.train_batch(tr, 7, 1, 50304)
    assert a["tokens"].shape == (tr["batch"], tr["seq"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    rows = [tuple(r) for r in np.concatenate([a["tokens"], b["tokens"]])]
    assert len(set(rows)) == len(rows)
