"""The comparison that decides ``correct``: what it counts as a gap."""

import numpy as np
import pytest

from benchmark.lib import compare


def _probs(z):
    return 1.0 / (1.0 + np.exp(-z))


@pytest.fixture
def reference():
    return np.random.default_rng(0).normal(0.0, 2.0, size=(64, 9))


def test_the_same_answers_read_nought(reference):
    err = compare.answer_errors(_probs(reference), _probs(reference))
    assert err.shape == (64,) and np.abs(err).max() < 1e-9


@pytest.mark.parametrize("shift", [0.25, -0.5, 1.0])
def test_a_shift_common_to_every_answer_counts(reference, shift):
    """A wrong bias moves every answer alike: its whole size is a gap."""
    err = compare.answer_errors(_probs(reference + shift), _probs(reference))
    np.testing.assert_allclose(err, shift ** 2, rtol=1e-6)


def test_another_reports_answer_reads_twice_the_spread(reference):
    err = compare.answer_errors(_probs(np.roll(reference, 1, axis=0)), _probs(reference))
    spread = np.mean(np.var(reference, axis=0))
    assert 1.5 * spread < err.mean() < 2.5 * spread


def test_a_row_that_is_not_finite_reads_infinite(reference):
    program = _probs(reference)
    program[3, 2] = np.nan
    err = compare.answer_errors(program, _probs(reference))
    assert np.isinf(err[3]) and np.isfinite(np.delete(err, 3)).all()


def test_exactly_once():
    assert compare.exactly_once(np.array([0, 1, 2, 3]), 4) == 0
    assert compare.exactly_once(np.array([0, 1, 1, 3]), 4) == 2
    assert compare.exactly_once(np.array([0, 1, 2, 3, 7]), 4) == 1
