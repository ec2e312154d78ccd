"""The device path of short documents (`repro_torch.core.sa.document`): the
word-id encoder against `binary_vectors` of the same documents spelled out
(the port's and the JAX package's), `DocumentIndex` against the IP
`GenieIndex` of the port and of the JAX package on the same vectors, and
its spans: one root `document.search` a search, `encode` inside it."""
import numpy as np
import pytest
import torch

from repro.core import GenieIndex as JGenieIndex
from repro.core.sa import document as jdocument
from repro_torch import trace
from repro_torch.core import GenieIndex, TopKMethod
from repro_torch.core.sa import DocumentIndex, document
from repro_torch.device import int64_sum

V = 64
# stop words among the first ranks, as the benchmark's vocabulary has them
VOCAB = ["the", "cat", "and", "dog", "of", "a"] + [f"w{i}" for i in range(6, 300)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _spelled(ids: torch.Tensor) -> list:
    return [" ".join(VOCAB[i] for i in row if i >= 0) for row in ids.tolist()]


def _word_ids(rows: int, width: int, seed: int, words: int = len(VOCAB)) -> torch.Tensor:
    """Word ids int32 [rows, width] with repeats, stop words, ragged -1 pads
    and an empty document."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, words, (rows, width), generator=g, dtype=torch.int32)
    length = torch.randint(0, width + 1, (rows, 1), generator=g)
    ids = torch.where(torch.arange(width) < length, ids, -1)
    ids[0] = -1
    ids[1, :4] = torch.tensor([1, 1, 0, 1], dtype=torch.int32)     # a repeat, a stop word
    return ids


def test_bucket_table_is_word_bucket_with_stop_words_minus_one():
    table = document.bucket_table(VOCAB, V, device="cpu")
    assert table.dtype == torch.int64 and table.shape == (len(VOCAB),)
    for w, b in zip(VOCAB, table.tolist()):
        assert b == (-1 if w in document.STOP_WORDS else document.word_bucket(w, V))


@pytest.mark.parametrize("v", [1, 7, V, 8192])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_word_vectors_equal_binary_vectors_of_the_spelled_documents(v, dtype):
    ids = _word_ids(40, 12, seed=v).to(dtype)
    got = document.word_vectors(ids, document.bucket_table(VOCAB, v, device="cpu"), v)
    assert got.dtype == torch.int8 and got.shape == (40, v)
    docs = _spelled(ids)
    want = document.binary_vectors(docs, v)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jdocument.binary_vectors(docs, v)))
    assert not got[0].any()


def test_word_vectors_set_bucket_zero_only_for_a_word_that_falls_there():
    table = torch.tensor([0, 3, -1, 0], dtype=torch.int64)
    ids = torch.tensor([[1, -1, 2], [2, -1, -1], [0, 1, -1], [3, 3, 2]], dtype=torch.int32)
    got = document.word_vectors(ids, table, 4)
    assert got.tolist() == [[0, 0, 0, 1], [0, 0, 0, 0], [1, 0, 0, 1], [1, 0, 0, 0]]


def _index(max_count=12, sizes=(70, 33, 90)) -> tuple:
    index = DocumentIndex(VOCAB, V, max_count, device="cpu")
    docs = [_word_ids(n, 12, seed=10 + i, words=40) for i, n in enumerate(sizes)]
    for d in docs:
        index.add(d)
    return index, torch.cat(docs)


@pytest.mark.parametrize("method", [TopKMethod.CPQ, TopKMethod.SPQ, TopKMethod.SORT])
def test_document_index_equals_the_ip_genie_index_of_both_packages(method):
    """Few words and short documents: many ties at the threshold."""
    index, docs = _index()
    queries = _word_ids(9, 12, seed=3, words=40)
    got = index.search(queries, k=15, method=method)
    assert index.index.n_objects == docs.shape[0]
    vecs = document.binary_vectors(_spelled(docs), V)
    qv = document.binary_vectors(_spelled(queries), V)
    want = GenieIndex.build_ip(vecs, max_count=12, device="cpu").search(qv, k=15, method=method)
    jwant = JGenieIndex.build_ip(vecs, max_count=12).search(qv, k=15)
    for other in (want, jwant):
        assert np.array_equal(got.ids.numpy(), np.asarray(other.ids))
        assert np.array_equal(got.counts.numpy(), np.asarray(other.counts))
        assert np.array_equal(got.threshold.numpy(), np.asarray(other.threshold))
    ties = (got.counts == got.threshold[:, None]).sum(dim=1)
    assert int(ties.max()) > 1
    # the counts are the overlaps of the bucket sets of the words
    def buckets(doc):
        return {document.word_bucket(w, V) for w in document.tokenize(doc)}

    docs_s, q_s = _spelled(docs), _spelled(queries)
    for qi in range(queries.shape[0]):
        for j, c in zip(got.ids[qi].tolist(), got.counts[qi].tolist()):
            assert c == len(buckets(q_s[qi]) & buckets(docs_s[j]))


def test_a_search_is_one_root_span_with_encode_and_its_counter():
    index, _ = _index()
    queries = _word_ids(5, 12, seed=4, words=40)
    trace.enable()
    index.search(queries, k=4)
    index.search(queries[:2], k=4)
    found = trace.searches()
    assert [s["name"] for s in found] == ["document.search"] * 2
    assert found[0]["attrs"] == {"k": 4}
    first = found[0]["children"]
    assert [c["name"] for c in first] == ["encode", "index.search"]
    # the encoding is timed, and counts nothing: no reader wants its word count
    assert first[0]["counters"] == {}
    assert not first[0]["children"]
    assert [c["name"] for c in first[1]["children"]] == ["part"] * 3 + ["merge"]
    assert [c["name"] for c in found[1]["children"]] == ["encode", "index.search"]
    assert found[1]["children"][0]["counters"] == {}


def test_adds_keep_no_span_and_spans_off_cost_no_counter():
    trace.enable()
    index, _ = _index()
    assert trace.searches() == []
    trace.disable()
    index.search(_word_ids(3, 12, seed=5, words=40), k=2)
    assert trace.searches() == []


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int32, torch.float32])
def test_int64_sum_in_blocks_equals_the_whole_sum(monkeypatch, dtype):
    """The blocked sum of the index's build (postings, routing centroids)."""
    import repro_torch.device as device

    monkeypatch.setattr(device, "SUM_BLOCK", 10)
    x = torch.randint(0, 100, (37, 3)).to(dtype)
    assert torch.equal(int64_sum(x, dim=0), x.to(torch.int64).sum(dim=0))
    assert int(int64_sum(x)) == int(x.to(torch.int64).sum())
    assert torch.equal(int64_sum(x[:0], dim=0), torch.zeros(3, dtype=torch.int64))
