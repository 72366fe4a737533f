"""The port's pure-Python WordPiece tokenizer against the JAX package's
``tokenizers``-backed one: identical ids on the same vocabulary."""

import json

import pytest

from memvul_tpu.data.synthetic import build_workspace, corpus_texts, generate_corpus
from memvul_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from memvul_tpu_torch.data.tokenizer import WordPieceTokenizer as PortTokenizer

EDGE_TEXTS = [
    "Café naïve ÅNGSTRÖM façade — résumé",                 # accents
    "日本語のテキスト 中文字符 한국어 mixed 漢字abc",          # CJK
    "foo-bar_baz (qux) {x}; a/b\\c 'q' \"d\" ¿¡ «guillemets» …",  # punctuation
    "nul\x00byte zero​width ctrl\x07bell � repl\ttab\nnl\r\x0bvt\xa0nbsp",
    "x" * 101 + " " + "y" * 100 + " normal",              # > 100 chars → [UNK]
    "ΣΑΣ İstanbul straße ǅemal ﬁ ligature ＡＢＣ fullwidth",
    "APITAG CODETAG NUMBERTAG [CLS] [SEP] [MASK] unseenwordzzq",
    "",
    "   ",
]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return build_workspace(tmp_path_factory.mktemp("tok"), seed=0)


@pytest.fixture(scope="module")
def texts(ws):
    reports, _ = generate_corpus(seed=0)
    return corpus_texts(reports) + list(ws["anchors"].values()) + EDGE_TEXTS


def test_tokenizer_json_ids_match(ws, texts):
    jax_tok = ws["tokenizer"]
    port = PortTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
    assert port.vocab_size == jax_tok.vocab_size
    assert (port.pad_id, port.cls_id, port.sep_id) == (jax_tok.pad_id, jax_tok.cls_id, jax_tok.sep_id)
    for text in texts:
        assert port.encode(text) == jax_tok.encode(text), text


def test_vocab_txt_ids_match(ws, texts, tmp_path):
    vocab = tmp_path / "vocab.txt"
    ws["tokenizer"].save_vocab_txt(vocab)
    jax_tok = JaxTokenizer(vocab_path=str(vocab))
    port = PortTokenizer(vocab_path=str(vocab))
    assert port.vocab_size == jax_tok.vocab_size
    for text in texts:
        assert port.encode(text) == jax_tok.encode(text), text
    # the port writes the same vocab.txt back
    again = tmp_path / "again.txt"
    port.save_vocab_txt(again)
    assert again.read_text(encoding="utf-8") == vocab.read_text(encoding="utf-8")


def test_vocab_txt_wins_over_tokenizer_json(ws, tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello"]) + "\n")
    port = PortTokenizer(vocab_path=str(vocab), tokenizer_path=ws["paths"]["tokenizer"])
    assert port.vocab_size == 5
    assert port.encode("hello there") == [2, 4, 1, 3]


@pytest.mark.parametrize("max_length", [1, 2, 3, 8, 33])
def test_truncation_keeps_sep(ws, texts, max_length):
    jax_tok = ws["tokenizer"]
    port = PortTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
    for text in texts[:40] + EDGE_TEXTS:
        got = port.encode(text, max_length=max_length)
        assert got == jax_tok.encode(text, max_length=max_length)
        assert len(got) <= max(max_length, 2)
        assert got[-1] == port.sep_id
    assert port.encode_many(texts[:5], max_length=16) == [
        port.encode(t, max_length=16) for t in texts[:5]
    ]


def test_build_deterministic_same_vocabulary(texts, tmp_path):
    jax_tok = JaxTokenizer.build_deterministic(texts, vocab_size=700, save_path=tmp_path / "j.json")
    port = PortTokenizer.build_deterministic(texts, vocab_size=700, save_path=tmp_path / "p.json")
    assert port._vocab == jax_tok._tok.get_vocab()
    assert port.vocab_size == jax_tok.vocab_size
    # the port's tokenizer.json loads in both packages and tokenizes alike
    jax_from_port = JaxTokenizer(tokenizer_path=str(tmp_path / "p.json"))
    port_from_jax = PortTokenizer(tokenizer_path=str(tmp_path / "j.json"))
    for text in texts[-len(EDGE_TEXTS):] + texts[:20]:
        want = jax_tok.encode(text)
        assert jax_from_port.encode(text) == want
        assert port_from_jax.encode(text) == want
        assert port.encode(text) == want


def test_trained_tokenizer_added_tokens_match_raw_text(texts, tmp_path):
    """A trained tokenizer.json carries the specials and tag tokens as added
    tokens, matched literally in the raw text before normalisation."""
    path = tmp_path / "trained.json"
    jax_tok = JaxTokenizer.train_from_corpus(texts, vocab_size=600, save_path=path)
    assert json.loads(path.read_text())["added_tokens"]
    port = PortTokenizer(tokenizer_path=str(path))
    assert port.vocab_size == jax_tok.vocab_size
    for text in texts[-len(EDGE_TEXTS):] + [
        "xAPITAGy [CLS]hello[SEP] apitag NUMBERTAGNUMBERTAG", texts[0],
    ]:
        assert port.encode(text) == jax_tok.encode(text), text


def test_non_wordpiece_model_raises(tmp_path):
    path = tmp_path / "bpe.json"
    path.write_text(json.dumps({"model": {"type": "BPE", "vocab": {}}}))
    with pytest.raises(ValueError, match="not WordPiece"):
        PortTokenizer(tokenizer_path=str(path))


@pytest.mark.parametrize("seed", range(3))
def test_random_ascii_ids_match(ws, seed):
    """Every ASCII character, control characters included, through the
    port's ASCII fast path against ``tokenizers``."""
    import random

    rng = random.Random(seed)
    jax_tok = ws["tokenizer"]
    port = PortTokenizer(tokenizer_path=ws["paths"]["tokenizer"])
    words = ["the", "parser", "overflow", "NUMBERTAG", "x"]
    for _ in range(300):
        text = "".join(
            rng.choice(words) if rng.random() < 0.2 else chr(rng.randrange(128))
            for _ in range(rng.randrange(40))
        )
        assert port.encode(text) == jax_tok.encode(text), repr(text)
