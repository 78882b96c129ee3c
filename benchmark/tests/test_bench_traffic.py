"""The traffic generator and the check's sample: the same seed gives the
same requests; another seed gives the same work (sizes, prompt lengths) in
another order, with other words and request seeds; the requests the check
compares are drawn from the seed before the window."""

import collections

from benchmark import check, spec, traffic


def _mix(name):
    return spec.load_json(spec.BENCH_DIR / "traffic" / f"{name}.json")


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_closed_is_deterministic_per_seed():
    t = _mix("t2i1024-closed")
    a, b = _take(traffic.closed_requests(t, 7), 300), _take(traffic.closed_requests(t, 7), 300)
    assert a == b
    c = _take(traffic.closed_requests(t, 2**31 + 5), 300)
    assert a != c
    assert sorted(len(r["prompt"].split()) for r in a[:256]) == sorted(len(r["prompt"].split()) for r in c[:256])


def test_closed_prompts_and_seeds_are_unique():
    reqs = _take(traffic.closed_requests(_mix("t2i1024-closed"), 11), 600)
    assert len({r["prompt"] for r in reqs}) == 600
    assert len({r["seed"] for r in reqs}) == 600
    words = [len(r["prompt"].split()) for r in reqs]
    assert min(words) >= 8 and max(words) <= 130
    assert all((r["height"], r["width"], r["steps"]) == (1024, 1024, 4) for r in reqs)


def test_other_seed_same_sizes_in_another_order():
    t = dict(_mix("t2i1024-closed"), sizes=[{"px": 256, "share": 0.5}, {"px": 512, "share": 0.25},
                                           {"px": 768, "share": 0.25}])
    a, c = _take(traffic.closed_requests(t, 3), 512), _take(traffic.closed_requests(t, 4), 512)
    for block in (slice(0, 256), slice(256, 512)):
        assert collections.Counter(r["height"] for r in a[block]) == {256: 128, 512: 64, 768: 64}
        assert collections.Counter(r["height"] for r in c[block]) == {256: 128, 512: 64, 768: 64}
    assert [r["height"] for r in a] != [r["height"] for r in c]


def test_check_positions_are_drawn_from_the_seed_before_the_window():
    t = dict(_mix("t2i1024-closed"), sizes=[{"px": 256, "share": 0.75}, {"px": 512, "share": 0.25}],
             check={"requests": 3, "among": 12})
    stream = _take(traffic.closed_requests(t, 5), 15)
    picked = check.positions(t, 5)
    assert picked == check.positions(t, 5)
    assert len(picked) == 3 and len({i for i, _ in picked}) == 3
    assert all(t["clients"] <= i < t["clients"] + 12 and r == stream[i] for i, r in picked)
    assert picked[0][1]["height"] == max(r["height"] for r in stream[3:15])
    assert {tuple(i for i, _ in check.positions(t, s)) for s in range(20)} != {tuple(i for i, _ in picked)}
