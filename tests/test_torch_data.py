"""The port's data pipeline (``repro_torch.data``) against the JAX
package's, on the CPU: both are numpy, so every batch must be
``array_equal`` — over seeds, steps, noise, order and host counts, and
across a resume from the two-int ``DataState``.  Also the reference's
own behavioural cases on the port."""

import numpy as np
import pytest

from repro.data import DataState as JDataState
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_pipeline as jmake_pipeline
from repro_torch.data import DataState, SyntheticLM, make_pipeline
from repro_torch.data.pipeline import host_rows

SRC = SyntheticLM(vocab_size=64, seq_len=32, global_batch=8)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("step", [0, 1, 999])
@pytest.mark.parametrize("order,noise", [(1, 0.05), (2, 0.1)])
def test_batches_equal_reference(seed, step, order, noise):
    kw = dict(vocab_size=512, seq_len=24, global_batch=6, seed=seed, noise=noise,
              order=order)
    _equal(SyntheticLM(**kw).batch_at(DataState(step, 3)),
           JSyntheticLM(**kw).batch_at(JDataState(step, 3)))


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 5, 8])
def test_host_slices_equal_reference(num_hosts):
    kw = dict(vocab_size=100, seq_len=16, global_batch=8, seed=1)
    for h in range(num_hosts):
        _, got = next(make_pipeline(SyntheticLM(**kw), DataState(4, 2), host_id=h,
                                    num_hosts=num_hosts))
        want_state, want = next(jmake_pipeline(JSyntheticLM(**kw), JDataState(4, 2),
                                               host_id=h, num_hosts=num_hosts))
        _equal(got, want)
        assert want_state.step == 5


def test_resume_mid_stream_equal_reference():
    """Five batches, then a pipeline resumed from the serialized state:
    the continuation equals both the uninterrupted stream and the
    reference's."""
    it, jit_ = make_pipeline(SRC, DataState(0, 7)), jmake_pipeline(
        JSyntheticLM(vocab_size=64, seq_len=32, global_batch=8), JDataState(0, 7))
    for _ in range(5):
        state, _ = next(it)
        next(jit_)
    _, want = next(it)
    _, jwant = next(jit_)
    _, got = next(make_pipeline(SRC, DataState(state.step, state.seed)))
    _equal(got, want)
    _equal(got, jwant)


def test_labels_are_shifted_tokens():
    b = SRC.batch_at(DataState(0, 0))
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("num_hosts", range(1, 9))
def test_host_rows_partition_batch(num_hosts):
    rows = np.concatenate([host_rows(SRC.global_batch, h, num_hosts)
                           for h in range(num_hosts)])
    np.testing.assert_array_equal(np.sort(rows), np.arange(SRC.global_batch))
