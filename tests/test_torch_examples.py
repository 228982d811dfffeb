"""The port's examples (``repro_torch.examples``) run on ``--device cpu``
with tiny arguments, each through its ``main(argv)``:

* quickstart: the TBN integer core equal to the float reference (exact),
  ``qmm`` equal to the QAT forward within its stated 1e-5, a tuned plan
  (in a plan cache under the test's tmp dir);
* serve_batch: every request of a packed ``tnn`` engine finishes "ok"
  with at least one token;
* train_tinylm: ``tnn`` QAT on a one-layer cut; ``main`` raises unless
  the mean of the last ten losses is 0.5 below ln(V), and the loss falls.

One thread each: the plain versions' many small ops run slower on a
contended machine with more.
"""

import math

import pytest
import torch

from repro_torch.examples import quickstart, serve_batch, train_tinylm


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_cpu(one_thread, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "plans.json"))
    out = quickstart.main(["--device", "cpu"])
    assert out["tbn_exact"] and out["qmm_equals_qat"]
    assert out["k_max_16"] == 32767
    assert out["bnn_packed_bytes"] < 256 * 64 * 4 // 16


def test_serve_batch_cpu(one_thread):
    res = serve_batch.main(["--device", "cpu", "--quant", "tnn", "--packed", "--requests", "4",
                            "--slots", "2", "--new-tokens", "6"])
    assert sorted(res) == [0, 1, 2, 3]
    assert all(r.status == "ok" and len(r.tokens) >= 1 for r in res.values())


def test_train_tinylm_cpu(one_thread, tmp_path):
    res = train_tinylm.main(["--device", "cpu", "--quant", "tnn", "--steps", "20",
                             "--d-model", "64", "--layers", "1", "--vocab", "64", "--batch", "8",
                             "--seq", "32", "--lr", "1e-2", "--checkpoint-dir",
                             str(tmp_path / "ckpt")])
    assert res.final_step == 20 and len(res.losses) == 20
    assert sum(res.losses[-5:]) / 5 < min(res.losses[:5]) < math.log(64) + 1


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for mod in (quickstart, serve_batch, train_tinylm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([] if mod is not train_tinylm else ["--steps", "1"])
