"""The port's data generators (`repro_torch.data.pipeline`) and GENIE dataset
configs (`repro_torch.configs.genie_datasets`) against the JAX package's:
every generator byte for byte for three seeds, and `DATASETS` field for
field."""
import dataclasses

import numpy as np
import pytest

from repro.configs import genie_datasets as jds
from repro.data import pipeline as jpipe
from repro.models.registry import get_config as jget_config
from repro_torch.configs import genie_datasets as ds
from repro_torch.data import pipeline as pipe
from repro_torch.models.registry import get_config

SEEDS = (0, 1, 12345)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_array_generators_equal_reference_byte_for_byte(seed):
    for kw in (dict(n=500, dim=16), dict(n=300, dim=7, n_clusters=3, cluster_std=0.9)):
        got, want = pipe.synthetic_points(seed=seed, **kw), jpipe.synthetic_points(seed=seed, **kw)
        _same(got[0], want[0])
        _same(got[1], want[1])
    assert pipe.synthetic_sequences(40, seed=seed) == jpipe.synthetic_sequences(40, seed=seed)
    assert (pipe.synthetic_sequences(9, length=13, alphabet="xyz", seed=seed)
            == jpipe.synthetic_sequences(9, length=13, alphabet="xyz", seed=seed))
    s = jpipe.synthetic_sequences(1, length=40, seed=seed)[0]
    for rate in (0.0, 0.1, 0.3, 1.0):
        assert pipe.mutate_sequence(s, rate, seed=seed) == jpipe.mutate_sequence(s, rate, seed=seed)
    assert pipe.synthetic_documents(30, seed=seed) == jpipe.synthetic_documents(30, seed=seed)
    assert (pipe.synthetic_documents(7, vocab_words=50, words_per_doc=3, seed=seed)
            == jpipe.synthetic_documents(7, vocab_words=50, words_per_doc=3, seed=seed))


@pytest.mark.parametrize("arch", ["smollm-360m-smoke", "internvl2-76b-smoke",
                                  "qwen2-moe-a2.7b-smoke"])
@pytest.mark.parametrize("seed", SEEDS)
def test_synthetic_tokens_equal_reference_byte_for_byte(arch, seed):
    data = pipe.DataConfig(seed=seed, global_batch=4, seq_len=24, n_hosts=2, host_id=1)
    jdata = jpipe.DataConfig(**dataclasses.asdict(data))
    assert data.host_batch == jdata.host_batch == 2
    got = pipe.SyntheticTokens(get_config(arch), data)
    want = jpipe.SyntheticTokens(jget_config(arch), jdata)
    _same(got.probs, want.probs)
    for step in (0, 3):
        g, w = got.batch(step), want.batch(step)
        assert sorted(g) == sorted(w)
        for key in g:
            _same(g[key], w[key])
    first = next(iter(got))
    _same(first["tokens"], want.batch(0)["tokens"])
    if arch.startswith("internvl2"):
        assert first["patch_embeds"].shape == (2, 8, 96)
        assert first["tokens"].shape == (2, 24 - 8)


def test_genie_datasets_equal_reference_field_for_field():
    assert ds.EPS == jds.EPS and ds.DELTA == jds.DELTA
    assert ds.M_PRACTICAL == jds.M_PRACTICAL == ds.m_paper() == jds.m_paper()
    assert list(ds.DATASETS) == list(jds.DATASETS)
    for name, cfg in ds.DATASETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jds.DATASETS[name])
    assert ([f.name for f in dataclasses.fields(ds.GenieDatasetConfig)]
            == [f.name for f in dataclasses.fields(jds.GenieDatasetConfig)])
