"""The port's GENIE dry-run (`repro_torch.launch.dryrun`) against the same
arithmetic on the JAX package's `repro.core.segments.layout_accounting` and
`repro.core.engines`, for the six datasets on worlds of 1 and 4, and its
per-rank memory model against bytes computed by hand.  (`repro.launch.dryrun`
itself is not loaded: it sets XLA_FLAGS at import and compiles for
minutes.)"""
import json

import pytest

from repro.configs.genie_datasets import DATASETS as JDATASETS
from repro.core import engines as jengines
from repro.core import segments as jsegments
from repro_torch.launch import dryrun

# the port keeps int32 where the reference chose int8 / int16, and int8 for IP
ELEMENT_BYTES = {"ocr": 4, "sift": 4, "sift_large": 4, "dblp": 4, "tweets": 1, "adult": 4}
REFERENCE_BYTES = {"ocr": 2, "sift": 1, "sift_large": 1, "dblp": 1, "tweets": 1, "adult": 4}


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("name", sorted(JDATASETS))
def test_cell_fields_equal_the_reference_arithmetic(name, world):
    ds = JDATASETS[name]
    rep = dryrun.run_genie_cell(name, world)
    width = ds.m if ds.engine != "range" else ds.dim
    sig = ELEMENT_BYTES[name]
    assert rep["element_bytes"] == sig
    assert rep["reference_element_bytes"] == REFERENCE_BYTES[name]
    n = -(-ds.n_objects // world) * world
    n_local = n // world
    q = ds.queries_per_batch
    assert (rep["n_objects"], rep["n_queries"]) == (n, q)
    assert rep["model_flops"] == float(q) * n * width
    flops = 2.0 * q * n_local * width if ds.engine == "ip" else \
        float(q) * n_local * width + float(q) * n_local
    assert rep["kernel_model"] == dict(
        flops=flops, bytes_accessed=n_local * width * sig + q * width * sig
        + 2.0 * 4 * q * n_local)
    ingest = jsegments.even_segments(ds.n_objects, 16)
    compacted = [ingest[i] + ingest[i + 1] for i in range(0, 16, 2)]
    seg = rep["segmented"]
    assert seg["pad_rows"] == n - ds.n_objects
    assert seg["ingest"] == jsegments.layout_accounting(ingest, width * sig)
    assert seg["compacted"] == jsegments.layout_accounting(compacted, width * sig)
    model = jengines.get(ds.engine)
    assert seg["signatures"] == dict(
        packed_supported=model.supports_packed, bytes_per_object_wide=width * sig,
        bytes_per_object_packed=None, ingest_packed=None, compacted_packed=None)
    plan = rep["plan"]
    assert plan["engine"] == ds.engine and plan["k"] == ds.default_k
    if world == 1:
        assert plan["layout"] == "segmented" and plan["part_rows"] == compacted
    else:
        assert plan["layout"] == "distributed" and plan["n_objects"] == ds.n_objects
        assert plan["merge"] == "collective"
    mem = rep["memory"]
    assert mem["card_bytes"] == 80 * 2**30 and "no card" in mem["card_bytes_source"]
    assert mem["fits"] == (mem["per_rank"]["peak"] <= mem["card_bytes"])
    json.dumps(rep)


@pytest.mark.parametrize("q", [256, 1024])
def test_memory_model_for_sift_by_hand(q):
    """SIFT: 4.5 M rows of 237 int32 signatures; k = 100, so a cap of 200."""
    row = 237 * 4
    small = q * row + q * 238 * 4 + 4 * q * 201 * 4
    one = dryrun.run_genie_cell("sift", 1, n_queries=q)["memory"]["per_rank"]
    counts = q * 562_500 * 4                              # one compacted segment
    assert one == dict(segments=4_500_000 * row, placed=0, counts=counts,
                       compaction=int(3.25 * counts), queries=q * row,
                       histogram=q * 238 * 4, buffers=4 * q * 201 * 4,
                       peak=4_500_000 * row + counts + int(3.25 * counts) + small)
    four = dryrun.run_genie_cell("sift", 4, n_queries=q)["memory"]["per_rank"]
    counts = q * 1_125_000 * 4                            # one rank's shard
    assert four["placed"] == 1_125_000 * row and four["counts"] == counts
    assert four["peak"] == (4_500_000 + 1_125_000) * row + counts + int(3.25 * counts) + small
    # chip_smoke.py phase 4k's cell: DISTRIBUTED on one rank, the whole
    # corpus one part, beside the service's segments (m = 238 there)
    shard = dryrun.memory_model(n_objects=4_500_000, row_bytes=238 * 4, n_queries=q,
                                part_rows=4_500_000, placed_rows=4_500_000,
                                query_bytes=238 * 4, max_count=238, cap=200)
    counts = q * 4_500_000 * 4
    assert shard["peak"] == 2 * 4_500_000 * 238 * 4 + counts + int(3.25 * counts) \
        + q * 238 * 4 + q * 239 * 4 + 4 * q * 201 * 4
    if q == 256:                                          # PERF.md section 4: ~28 GB
        assert 27e9 < shard["peak"] < 29e9


def test_main_takes_only_the_genie_cells(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "REPORT_DIR", str(tmp_path))
    dryrun.main(["--genie", "--world", "4", "--n-queries", "64"])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"genie__{d}__search_64q__world4.json" for d in JDATASETS)
    assert "fits=" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main([])
    with pytest.raises(ValueError, match="world"):
        dryrun.run_genie_cell("sift", 2)
