"""The port's ``utils/metrics.py`` against the JAX package's, on seeded arrays.

Both modules are numpy; the port's is a copy, so every number must be equal
bit for bit (NaN where the JAX module gives NaN): the regression, binary
and multiclass metrics, ties in the scores, a single class (AUROC NaN), a
constant prediction (Pearson r 0), the head-task aliases, and the bootstrap
intervals, whose generator is drawn anew from the same seed on every call.
"""

import numpy as np
import pytest

from deepcoro_clip_tpu.utils import metrics as jm
from deepcoro_clip_tpu_torch.utils import metrics as tm


def _equal(got, want):
    """Equal as the JAX module's result is, nested dicts and NaNs included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got)
    else:
        assert got == want and type(got) is type(want), (got, want)


def _binary(seed, n=40, ties=False, one_class=None):
    r = np.random.default_rng(seed)
    scores = r.normal(size=n).astype(np.float32)
    if ties:
        scores = np.round(scores, 0)  # few distinct values: many tied ranks
    labels = (r.random(n) > 0.5).astype(np.float32)
    if one_class is not None:
        labels[:] = one_class
    return scores, labels


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_roc_auc_and_auprc_match_jax(ties):
    for seed in range(5):
        s, t = _binary(seed, ties=ties)
        s64 = s.astype(np.float64)
        _equal(tm._roc_auc(s64, t), jm._roc_auc(s64, t))
        _equal(tm._auprc(s64, t), jm._auprc(s64, t))


@pytest.mark.parametrize("case", ["distinct", "ties", "one_class_0", "one_class_1",
                                  "threshold"])
def test_binary_metrics_match_jax(case):
    one = {"one_class_0": 0.0, "one_class_1": 1.0}.get(case)
    s, t = _binary(3, ties=case == "ties", one_class=one)
    thr = 0.4 if case == "threshold" else None
    got, want = tm.binary_metrics(s, t, thr), jm.binary_metrics(s, t, thr)
    _equal(got, want)
    if one is not None:
        assert np.isnan(got["auc"])


def test_binary_threshold_search_over_many_scores():
    """Above 200 distinct probabilities the search takes 200 quantiles."""
    s, t = _binary(7, n=500)
    _equal(tm.binary_metrics(s, t), jm.binary_metrics(s, t))


@pytest.mark.parametrize("case", ["random", "constant_prediction", "one_sample"])
def test_regression_metrics_match_jax(case):
    r = np.random.default_rng(1)
    n = 1 if case == "one_sample" else 30
    p = r.normal(size=n).astype(np.float32)
    t = (p * 0.5 + r.normal(size=n)).astype(np.float32)
    if case == "constant_prediction":
        p[:] = 2.5
    got = tm.regression_metrics(p, t)
    _equal(got, jm.regression_metrics(p, t))
    if case != "random":
        assert got["pearson_r"] == 0.0


@pytest.mark.parametrize("case", ["random", "absent_class", "ties"])
def test_multiclass_metrics_match_jax(case):
    r = np.random.default_rng(2)
    logits = r.normal(size=(25, 3)).astype(np.float32)
    targets = r.integers(0, 3, size=25).astype(np.float32)
    if case == "absent_class":
        targets[targets == 2] = 0  # class 2 never the target: its AUROC is skipped
    if case == "ties":
        logits = np.round(logits)
    _equal(tm.multiclass_metrics(logits, targets), jm.multiclass_metrics(logits, targets))


@pytest.mark.parametrize("task", ["regression", "binary", "binary_classification",
                                  "multiclass", "multiclass_classification",
                                  "multi_class_classification"])
def test_normalize_head_task_matches_jax(task):
    assert tm.normalize_head_task(task) == jm.normalize_head_task(task)


@pytest.mark.parametrize("task", ["regression", "binary", "binary_classification",
                                  "multiclass", "multiclass_classification"])
@pytest.mark.parametrize("with_ci", [False, True], ids=["no_ci", "ci"])
def test_compute_head_metrics_match_jax(task, with_ci):
    r = np.random.default_rng(4)
    n = 24
    if "multiclass" in task:
        p = r.normal(size=(n, 3)).astype(np.float32)
        t = r.integers(0, 3, size=n).astype(np.float32)
    else:
        p = r.normal(size=n).astype(np.float32)
        t = ((r.random(n) > 0.5) if "binary" in task else r.normal(size=n)).astype(np.float32)
    got = tm.compute_head_metrics(p, t, task, with_ci=with_ci, n_bootstrap=50,
                                  confidence=0.9)
    _equal(got, jm.compute_head_metrics(p, t, task, with_ci=with_ci, n_bootstrap=50,
                                        confidence=0.9))
    assert any(k.endswith("_ci") for k in got) == with_ci


def test_compute_head_metrics_rejects_an_unknown_task():
    with pytest.raises(ValueError, match="unknown head task"):
        tm.compute_head_metrics(np.zeros(3), np.zeros(3), "ordinal")


@pytest.mark.parametrize("case", ["auc", "auc_one_class", "auc_small", "mae"])
def test_bootstrap_ci_matches_jax_bit_for_bit(case):
    """Equal intervals, NaN positions included: one class only gives a NaN
    AUROC for the point and every resample (the interval is NaN); four
    samples give resamples of one class, which are left out."""
    n = 4 if case == "auc_small" else 30
    s, t = _binary(5, n=n, one_class=0.0 if case == "auc_one_class" else None)
    if case == "mae":
        fn_t = lambda p, y: tm.regression_metrics(p, y)["mae"]  # noqa: E731
        fn_j = lambda p, y: jm.regression_metrics(p, y)["mae"]  # noqa: E731
    else:
        fn_t = lambda p, y: tm.binary_metrics(p, y)["auc"]  # noqa: E731
        fn_j = lambda p, y: jm.binary_metrics(p, y)["auc"]  # noqa: E731
    got = tm.bootstrap_ci(fn_t, s, t, n_bootstrap=100)
    _equal(got, jm.bootstrap_ci(fn_j, s, t, n_bootstrap=100))
    if case == "auc_one_class":
        assert np.isnan(got[0]) and np.isnan(got[1]) and np.isnan(got[2])
    # the generator is drawn anew: a second call gives the same bits
    _equal(tm.bootstrap_ci(fn_t, s, t, n_bootstrap=100), got)


def test_bootstrap_skips_a_resample_that_raises():
    calls = []

    def fn(p, y):
        calls.append(1)
        if len(calls) % 3 == 0:
            raise ValueError("degenerate resample")
        return float(p.mean())

    p = np.arange(10, dtype=np.float64)
    got = tm.bootstrap_ci(fn, p, p, n_bootstrap=30)
    calls.clear()
    want = jm.bootstrap_ci(fn, p, p, n_bootstrap=30)
    _equal(got, want)
