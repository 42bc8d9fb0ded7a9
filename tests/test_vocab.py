from asr_chinese_e2e.data.vocab import (
    BOS_ID,
    EOS_ID,
    PAD_ID,
    UNK_ID,
    Vocab,
)


def build_vocab(sentences):
    v = Vocab()
    v.consume_sentence_list(sentences)
    return v.build()


def test_special_token_contract():
    v = build_vocab(["你好"])
    assert v.str_to_ids("$")[0] == PAD_ID == 0
    assert v.str_to_ids("%")[0] == UNK_ID == 1
    assert v.str_to_ids("^")[0] == BOS_ID == 2
    assert v.str_to_ids("&")[0] == EOS_ID == 3


def test_str_roundtrip_and_unk():
    v = build_vocab(["你好世界", "你好"])
    ids = v.str_to_ids("你好")
    assert v.ids_to_str(ids) == "你 好"
    assert v.str_to_ids("ζ") == [UNK_ID]  # unseen char maps to UNK


def test_bos_eos_wrapping():
    v = build_vocab(["你好"])
    ids = v.str_to_ids("你", use_bos=True, use_eos=True)
    assert ids[0] == BOS_ID and ids[-1] == EOS_ID


def test_pad_stripped_in_detok():
    # CER parity depends on PAD stripping (reference vocab.py:75-79)
    v = build_vocab(["你好"])
    ids = v.str_to_ids("你好") + [PAD_ID, PAD_ID]
    assert v.ids_to_str(ids) == "你 好"


def test_min_count_and_frequency_order():
    v = Vocab()
    v.consume_sentence_list(["aab", "ab"])  # a:3 b:2
    v.build(min_count=2)
    ids = v.str_to_ids("ab")
    assert ids[0] == 4 and ids[1] == 5  # most-common-first after specials


def test_save_load_fingerprint(tmp_path):
    v = build_vocab(["你好世界"])
    p = str(tmp_path / "vocab.json")
    v.save(p)
    v2 = Vocab.load(p)
    assert v2.vocab_size == v.vocab_size
    assert v2.fingerprint() == v.fingerprint()
    assert v2.str_to_ids("世界") == v.str_to_ids("世界")
