"""The traffic generator: runs repeat by seed; seeds share the mix's
schedule and differ in token ids."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from ldsbench import traffic

MIXES = Path(__file__).resolve().parent / "traffic"


def load(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat", "decode", "docqa"])
def test_same_seed_same_requests(name):
    a = traffic.build(load(name), 50000, 2 ** 31 + 12345, 40.0)
    b = traffic.build(load(name), 50000, 2 ** 31 + 12345, 40.0)
    assert len(a.requests) == len(b.requests)
    for x, y in zip(a.requests, b.requests):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.greedy, x.sample_seed, x.due, x.doc) == (
            y.max_new, y.greedy, y.sample_seed, y.due, y.doc)


@pytest.mark.parametrize("name", ["chat", "decode", "docqa"])
def test_seeds_send_the_same_schedule_with_other_tokens(name):
    a = traffic.build(load(name), 50000, 1, 40.0)
    b = traffic.build(load(name), 50000, 2 ** 33 + 5, 40.0)
    assert [(len(x.prompt), x.max_new, x.greedy, x.due, x.doc)
            for x in a.requests] == [(len(y.prompt), y.max_new, y.greedy,
                                      y.due, y.doc) for y in b.requests]
    assert [len(d) for d in a.documents] == [len(d) for d in b.documents]
    assert not np.array_equal(a.requests[0].prompt, b.requests[0].prompt)
    assert [x.sample_seed for x in a.requests] != [y.sample_seed
                                                   for y in b.requests]


def test_the_schedule_seed_reorders_the_same_work():
    mix = load("chat")
    a = traffic.build(mix, 49152, 1, 40.0)
    b = traffic.build({**mix, "schedule_seed": mix["schedule_seed"] + 1},
                      49152, 1, 40.0)
    assert (Counter(len(r.prompt) for r in a.requests)
            == Counter(len(r.prompt) for r in b.requests))
    assert (Counter(r.max_new for r in a.requests)
            == Counter(r.max_new for r in b.requests))
    assert [len(r.prompt) for r in a.requests] != [len(r.prompt)
                                                   for r in b.requests]


def test_open_loop_arrivals_fill_the_window():
    mix = load("chat")
    tr = traffic.build(mix, 49152, 7, 40.0)
    due = np.array([r.due for r in tr.requests])
    assert len(due) == round(mix["rate_per_s"] * 40.0)
    assert due.min() == 0.0 and due.max() < 40.0
    gaps = np.diff(np.sort(due))
    # exponential gaps: the spread of a Poisson stream, not a metronome
    assert gaps.std() / gaps.mean() > 0.8


def test_lengths_stay_in_their_bounds():
    mix = load("chat")
    tr = traffic.build(mix, 49152, 3, 40.0)
    lens = [len(r.prompt) for r in tr.requests]
    outs = [r.max_new for r in tr.requests]
    assert min(lens) >= 32 and max(lens) <= 2048
    assert min(outs) >= 16 and max(outs) <= 512
    assert 200 <= float(np.median(lens)) <= 320


def test_closed_loop_first_requests_start_spread_out():
    mix = load("decode")
    tr = traffic.build(mix, 50280, 5, 40.0)
    first = [r.max_new for r in tr.requests[:tr.clients]]
    rest = [r.max_new for r in tr.requests[tr.clients:]]
    assert min(rest) >= 1024
    assert min(first) < 200 and max(first) <= 2048


def test_documents_follow_zipf():
    mix = load("docqa")
    tr = traffic.build(mix, 49152, 11, 40.0)
    counts = Counter(r.doc for r in tr.requests)
    assert counts[0] > counts[1] > counts[3] > counts[7] > 0
    for r in tr.requests[:20]:
        doc = tr.documents[r.doc]
        assert np.array_equal(r.prompt[:len(doc)], doc)
        assert 32 <= len(r.prompt) - len(doc) <= 128


def test_check_sample_keeps_the_longest():
    class R:
        def __init__(self, i, n, greedy):
            self.idx, self.n_out, self.greedy = i, n, greedy
            self.prompt_len = 10

    done = [R(i, 5 + i, i % 2 == 0) for i in range(30)]
    pick = traffic.check_sample(done, {"greedy": 3, "sampled": 2}, 99)
    assert pick[0].idx == 29
    assert len(pick) == 6
    assert pick == traffic.check_sample(done, {"greedy": 3, "sampled": 2}, 99)
