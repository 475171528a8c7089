"""The port's synthetic token pipeline against the JAX package's.

``repro_torch.data`` keeps its own copy of ``repro.data.pipeline`` (pure
numpy), so batches and host slices must be bit-equal for any step and
row range; plus ports of the reference's own data tests
(``tests/test_fault.py``: determinism per step, labels are the tokens
shifted, host slices partition the global batch)."""

import numpy as np
import pytest

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokens as RefTokens
from repro_torch.data import DataConfig, SyntheticTokens

CONFIGS = [dict(vocab=100, global_batch=4, seq_len=16),
           dict(vocab=122753, global_batch=8, seq_len=130, seed=7),
           dict(vocab=256, global_batch=6, seq_len=48, seed=3,
                copy_period=5, noise=0.3)]


def _pair(kw):
    return SyntheticTokens(DataConfig(**kw)), RefTokens(RefDataConfig(**kw))


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("step", [0, 1, 17, 10_000])
def test_batches_bit_equal(kw, step):
    port, ref = _pair(kw)
    got, want = port.batch(step), ref.batch(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("rows", [(0, 1), (1, 3), (2, 4)])
def test_row_ranges_bit_equal(kw, rows):
    port, ref = _pair(kw)
    for step in (0, 5):
        got, want = port.batch(step, *rows), ref.batch(step, *rows)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_host_slices_bit_equal(n_hosts):
    port, ref = _pair(dict(vocab=500, global_batch=8, seq_len=24, seed=1))
    for step in (0, 3, 9):
        for h in range(n_hosts):
            got = port.host_slice(step, h, n_hosts)
            want = ref.host_slice(step, h, n_hosts)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic_per_step():
    d = SyntheticTokens(DataConfig(vocab=100, global_batch=4, seq_len=16))
    a = d.batch(7)
    b = d.batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = d.batch(8)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_labels_are_shifted_tokens():
    d = SyntheticTokens(DataConfig(vocab=100, global_batch=2, seq_len=16))
    b = d.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_slices_partition_global_batch():
    d = SyntheticTokens(DataConfig(vocab=100, global_batch=8, seq_len=8))
    full = d.batch(3)
    parts = [d.host_slice(3, h, 4) for h in range(4)]
    glued = np.concatenate([p["tokens"] for p in parts], axis=0)
    np.testing.assert_array_equal(full["tokens"], glued)
