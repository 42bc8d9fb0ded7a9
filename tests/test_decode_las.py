"""Beam search over the LAS recurrent decoder state (generic cache
reordering must handle carries/alignment, not just KV tensors)."""

import jax
import numpy as np

from asr_chinese_e2e.decode.beam import beam_search
from asr_chinese_e2e.decode.greedy import attention_greedy_decode, tokens_to_ids
from asr_chinese_e2e.models.rnn import LAS, default_las_config

from tests.test_rnn_models import VOCAB, make_batch


def setup_las():
    cfg = default_las_config().build(
        hidden_size=16, embed_dim=12, attention_dim=12, input_dim=10,
        num_encoder_layers=1, dropout_rate=0.0, location_kernel=5,
    )
    model = LAS(cfg, VOCAB)
    feats, feat_lens, labels, label_lens = make_batch()
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, labels, label_lens)
    enc_out, enc_lens = model.apply(params, feats, feat_lens, method="encode")
    return model, params, enc_out, enc_lens


def test_las_beam1_matches_greedy():
    model, params, enc_out, enc_lens = setup_las()
    tokens, _ = attention_greedy_decode(model, params, enc_out, enc_lens, 6)
    res = beam_search(model, params, enc_out, enc_lens, beam_size=1, max_len=6)
    g = tokens_to_ids(tokens)
    b = res.nbest_ids(1)
    for i in range(enc_out.shape[0]):
        assert g[i] == b[i][0]


def test_las_beam_sorted_finite():
    model, params, enc_out, enc_lens = setup_las()
    res = beam_search(model, params, enc_out, enc_lens, beam_size=3, max_len=5)
    assert res.tokens.shape == (2, 3, 5)
    for i in range(2):
        assert (np.diff(res.scores[i]) <= 1e-6).all()
        assert np.isfinite(res.scores[i][0])
