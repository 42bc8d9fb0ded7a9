"""CER metric unit tests.

``calculate_cer`` parity with the reference formula
(``Predictor/Utils/score.py:4-13``) and the teacher-forced
``batch_cer_from_ids`` EOS-truncation fix (round-3 VERDICT #5): post-EOS
argmax garbage must not count as insertions.
"""

import numpy as np

from asr_chinese_e2e.data.vocab import EOS_ID, PAD_ID, Vocab
from asr_chinese_e2e.decode.cer import batch_cer_from_ids, calculate_cer


def _vocab():
    v = Vocab()
    v.consume_sentence_list(["abcde"])
    return v.build()


def test_calculate_cer_reference_formula():
    # Levenshtein over space-joined chars / ref space-token count
    assert calculate_cer("a b c", "a b c") == 0.0
    # one substitution in 3 ref tokens -> distance 1 / 3
    assert abs(calculate_cer("a x c", "a b c") - 1 / 3) < 1e-9
    # insertion of ' d' (2 chars incl. space) -> distance 2 / 3
    assert abs(calculate_cer("a b c d", "a b c") - 2 / 3) < 1e-9


def test_tf_cer_perfect_prediction_is_zero():
    v = _vocab()
    a = v.str_to_ids("abc") + [EOS_ID]
    gold = np.array([a + [PAD_ID] * 3])
    # hyp matches up to EOS, then predicts garbage at pad positions — the
    # garbage must be ignored (the reference metric counts it: 117-140%
    # "CER" at flagship shapes, round-3 soak)
    garbage = v.str_to_ids("ede")
    hyp = np.array([a[:3] + [EOS_ID] + garbage])
    assert batch_cer_from_ids(hyp, gold, v) == 0.0


def test_tf_cer_counts_real_errors_only():
    v = _vocab()
    ids = v.str_to_ids("abcd")
    gold = np.array([ids + [EOS_ID, PAD_ID]])
    # one substitution before EOS + garbage after EOS
    hyp_ids = list(ids)
    hyp_ids[1] = v.str_to_ids("e")[0]
    hyp = np.array([hyp_ids + [EOS_ID, v.str_to_ids("a")[0]]])
    got = batch_cer_from_ids(hyp, gold, v)
    assert abs(got - 100.0 * 1 / 4) < 1e-6


def test_tf_cer_no_eos_in_hyp_uses_full_row():
    v = _vocab()
    ids = v.str_to_ids("ab")
    gold = np.array([ids + [EOS_ID]])
    hyp = np.array([ids + [ids[0]]])  # never emits EOS
    # ref "a b", hyp "a b a": distance 2 over 2 ref tokens
    assert abs(batch_cer_from_ids(hyp, gold, v) - 100.0) < 1e-6
