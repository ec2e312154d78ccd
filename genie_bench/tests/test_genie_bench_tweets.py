"""The tweets-ip cell at a size the CPU runs in a second: its plain reference
against a brute-force intersection of bucket sets, its inputs per seed, a
run end to end (correct, untraced and traced), the control and a planted
fault read as faulty, the least work on a hand-made example, the
readers of its encoding and of its count on canned searches, and the
per-layer metrics that list the cell."""
import json
import zlib

import pytest
import torch

from genie_bench import run
from genie_bench.harness import cell as cell_lib, control
from genie_bench.harness import trace as trace_lib
from genie_bench.harness.peaks import OPS_PER_S, Context
from genie_bench.harness.program import ROOT
from genie_bench.reference import word_ip
from genie_bench.tests.tiny import MIXES, one_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
NAME = "tweets-ip.batch1024"
# the cell cut to the tests' size (tiny.py's SIZES holds the older cells)
SIZE = dict(n_objects=4000, segments=4, vocab_words=600, k=10, check_queries=64)


def tiny(**sizes):
    cell = cell_lib.load(ROOT, NAME)
    cell.cfg.update(SIZE, **sizes)
    cell.mix = dict(cell.mix, **MIXES[cell.mix["loop"]])
    return cell


def _bucket_sets(cfg, words):
    stop = set(cfg["stop_words"])
    vocab = word_ip.vocabulary(cfg)
    return [{zlib.crc32(vocab[i].encode()) % cfg["n_buckets"] for i in row
             if i >= 0 and vocab[i] not in stop} for row in words.tolist()]


def test_the_vocabulary_starts_with_the_stop_words_and_names_the_rest():
    cfg = tiny().cfg
    vocab = word_ip.vocabulary(cfg)
    assert len(vocab) == cfg["vocab_words"] and len(set(vocab)) == len(vocab)
    assert vocab[:25] == cfg["stop_words"] and vocab[25] == "w25" and vocab[-1] == "w599"
    from repro_torch.core.sa import document

    assert set(cfg["stop_words"]) == set(document.STOP_WORDS)


def test_reference_counts_equal_a_brute_force_intersection():
    cfg = tiny(n_buckets=64).cfg                  # collisions between words too
    inp = word_ip.inputs(cfg, 5, CPU)
    docs = word_ip.corpus_chunk(cfg, 5, inp, 1, CPU)[:300]
    queries = word_ip.queries(cfg, 5, inp, [0], 20, CPU)
    b = word_ip.buckets(cfg, inp, docs)
    got = word_ip._ip_counts(word_ip.indicators(cfg, inp, queries), b, word_ip.first_seen(b))
    qs, ds = _bucket_sets(cfg, queries), _bucket_sets(cfg, docs)
    want = torch.tensor([[len(q & d) for d in ds] for q in qs], dtype=torch.int32)
    assert torch.equal(got, want)
    assert int(want.max()) > 1 and int((want == 0).sum()) > 0


def test_reference_counts_equal_the_ports_word_vectors():
    from repro_torch.core.sa import document

    cfg = tiny().cfg
    inp = word_ip.inputs(cfg, 6, CPU)
    docs = word_ip.corpus_chunk(cfg, 6, inp, 0, CPU)
    queries = word_ip.queries(cfg, 6, inp, [2], 30, CPU)
    table = document.bucket_table(word_ip.vocabulary(cfg), cfg["n_buckets"], device="cpu")
    assert torch.equal(table, inp["table"])
    dv = document.word_vectors(docs, table, cfg["n_buckets"]).to(torch.int32)
    qv = document.word_vectors(queries, table, cfg["n_buckets"]).to(torch.int32)
    b = word_ip.buckets(cfg, inp, docs)
    got = word_ip._ip_counts(word_ip.indicators(cfg, inp, queries), b, word_ip.first_seen(b))
    assert torch.equal(got, qv @ dv.T)


def test_tweets_have_their_lengths_and_queries_are_tweets_with_a_fifth_redrawn():
    cfg = tiny().cfg
    inp = word_ip.inputs(cfg, 7, CPU)
    per = word_ip.rows_per_add(cfg)
    chunks = [word_ip.corpus_chunk(cfg, 7, inp, s, CPU) for s in range(cfg["segments"])]
    corpus = torch.cat(chunks)
    length = (corpus >= 0).sum(dim=1)
    assert int(length.min()) == cfg["min_words"] and int(length.max()) == cfg["max_words"]
    assert bool(((corpus >= 0).int().diff(dim=1) <= 0).all())        # pads at the end
    assert corpus.dtype == torch.int32 and int(corpus.max()) < cfg["vocab_words"]
    stop = (corpus >= 0) & (corpus < 25)
    # the stop words' share of the words drawn is their mass under the law
    assert abs(float(stop.sum() / (corpus >= 0).sum()) - float(inp["cdf"][24])) < 0.02
    # the tweets the queries were made from: the first draw of the block's stream
    picks = torch.randint(0, cfg["n_objects"], (40,),
                          generator=word_ip.generator(7, "queries", 0, device=CPU))
    assert per * cfg["segments"] == cfg["n_objects"]
    q = word_ip.queries(cfg, 7, inp, [0], 40, CPU)
    src = corpus[picks]
    assert torch.equal(q >= 0, src >= 0)
    n = (src >= 0).sum(dim=1)
    changed = (q != src).sum(dim=1)
    assert bool((changed <= torch.round(n * 0.2)).all()) and int(changed.sum()) > 0


def test_inputs_are_the_same_for_a_seed_and_differ_across_seeds():
    cell = tiny()
    cfg = cell.cfg
    seed = 2 ** 40 + 7                            # past 32 bits
    runs = []
    for s in (seed, seed, seed + 1):
        inp = word_ip.inputs(cfg, s, CPU)
        runs.append([*inp.values(), word_ip.corpus_chunk(cfg, s, inp, 1, CPU),
                     word_ip.queries(cfg, s, inp, [0, 1], 16, CPU)])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][-2], runs[2][-2]) and not torch.equal(runs[0][-1], runs[2][-1])
    inp = word_ip.inputs(cfg, seed, CPU)
    assert torch.equal(word_ip.queries(cfg, seed, inp, [1], 16, CPU), runs[0][-1][16:])


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(trace):
    got = run.run_cell(tiny(), 2 ** 33 + 5, 0.3, trace, CPU, 0.0)
    assert got["correct"] and got["checks"] == {"answer_faults": {"value": 0, "limit": 0}}
    assert got["attempted"] > 0 and got["failed"] == 0
    if trace:
        # no device here: no span or kernel has a device time to read; what
        # needs none is read, and the ties make many candidates a slot
        assert set(got["metrics"]) == {"search.roofline_pct", "search.idle_ms",
                                       "cpq.candidates_per_k"} and "breakdown" in got
        assert got["metrics"]["cpq.candidates_per_k"]["value"] > 2
    else:
        assert set(got["metrics"]) == {"queries_per_s", "peak_device_gb", "setup_s"}


def test_the_control_is_read_as_faulty():
    readings = control.readings(tiny(), [7, 8, 9], CPU)
    assert min(readings) > 0, readings


def test_a_planted_fault_is_not_correct(monkeypatch):
    """One count too high at the head of each answer."""
    cell = tiny()
    system = cell.system().System
    search = system.search

    def broken(self, batch):
        out = search(self, batch)
        counts = out["counts"].clone()
        counts[:, 0] += 1
        return dict(out, counts=counts)

    monkeypatch.setattr(system, "search", broken)
    got = run.run_cell(cell, 11, 0.3, False, CPU, 0.0)
    assert not got["correct"] and got["checks"]["answer_faults"]["value"] > 0


def test_least_work_counts_the_shared_buckets_once():
    cfg = dict(n_buckets=8, k=2, n_objects=5, max_words=3)
    ind = torch.zeros((2, 9), dtype=torch.bool)
    ind[0, [1, 2]] = True
    ind[1, [2, 7]] = True
    holders = torch.tensor([0, 3, 1, 0, 0, 0, 0, 2])        # tweets holding each bucket
    got = word_ip.least_work(cfg, ind, holders)
    # q0 meets 3 + 1 tweets, q1 1 + 2; 6 holdings and 4 query buckets at 3 bits
    assert got["match"] == {"ops": 7, "bytes": (6 + 4) * 3 / 8}
    assert got["search"] == {"ops": 7 + 2 * 5,
                             "bytes": 6 * 3 / 8 + 2 * 3 * 4 + 2 * (2 * 2 + 1) * 4}


def _events(roots):
    ev = [{"ph": "X", "name": trace_lib.WINDOW, "cat": "user_annotation", "ts": 0, "dur": 1000}]
    ev += [{"ph": "X", "name": "repro_torch." + r, "cat": "user_annotation", "ts": 100 + 400 * i,
            "dur": 300} for i, r in enumerate(roots)]
    # the IP count as the profiler names it: 5 ms a request
    ev += [{"ph": "X", "name": "void (anonymous namespace)::ip_count_kernel<true>("
            "repro::s8_mma_tile::Params, CUtensorMap_st, CUtensorMap_st)", "cat": "kernel",
            "ts": 110 + 400 * i, "dur": 5} for i in range(len(roots))]
    return ev


def _search(root="document.search"):
    part = {"name": "part", "device_ms": 4.0, "attrs": {}, "counters": {}, "children": [
        {"name": "match", "device_ms": 2.5, "attrs": {}, "counters": {}, "children": []}]}
    return {"name": root, "device_ms": 6.0, "attrs": {}, "counters": {}, "children": [
        {"name": "encode", "device_ms": 0.25, "attrs": {}, "counters": {}, "children": []},
        {"name": "index.search", "device_ms": 5.0, "attrs": {}, "counters": {},
         "children": [part, part]}]}


def test_the_two_readers_on_canned_searches(monkeypatch):
    """`encode.device_ms`, the cell's own, and `match.roofline_pct`, which
    reads the cell's `count_kernels` by name."""
    from repro_torch import trace

    cfg = tiny().cfg
    found = [_search(), _search()]
    monkeypatch.setattr(trace, "searches", lambda n=None: found[len(found) - n:])
    work = {"match": {"ops": OPS_PER_S * 1e-3, "bytes": 0}, "search": {"ops": 0, "bytes": 0}}
    ctx = Context(cfg=cfg, trace=trace_lib.reduce(_events(["document.search"] * 2)), requests=2,
                  least_work=[work, work], own_kernels=None)
    assert cell_lib.metric_reader("encode.device_ms")(ctx) == pytest.approx(0.25)
    # 1 ms of least time against 5 us of `ip_count_kernel` a request
    assert cell_lib.metric_reader("match.roofline_pct")(ctx) == pytest.approx(100.0 * 1e-3 / 5e-6)
    ctx.requests = 3
    assert cell_lib.metric_reader("encode.device_ms")(ctx) is None
    # another cell's count kernel: nothing of this one's to read
    ctx = Context(cfg=dict(cfg, count_kernels=["match_count_kernel"]),
                  trace=trace_lib.reduce(_events(["document.search"] * 2)), requests=2,
                  least_work=[work, work], own_kernels=None)
    assert cell_lib.metric_reader("match.roofline_pct")(ctx) is None


def test_the_cell_is_read_by_every_layer_it_runs():
    """Each per-layer metric of the benchmark lists the cell, but the hash's,
    which it bypasses."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    missing = {m["name"] for m in bench["per_layer"] if NAME not in m.get("workloads", [NAME])}
    assert missing == {"hash.device_ms"}
