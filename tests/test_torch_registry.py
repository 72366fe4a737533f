"""The port's ``Registrable`` registry (``memvul_tpu_torch/registry.py``)
against the JAX package's: the eleven cases of ``tests/test_registry.py``
on the port's module, and ``build_tokenizer``/``build_reader`` of both
packages fed the same configs, good and bad: the same class with equal
attributes, or the same exception type and message."""

import typing

import pytest

import memvul_tpu.build as jax_build
import memvul_tpu_torch
import memvul_tpu_torch.build as port_build
from memvul_tpu_torch.data.readers import DatasetReader, MemoryReader, SingleReader
from memvul_tpu_torch.data.tokenizer import TextTokenizer, WordPieceTokenizer, WordTokenizer
from memvul_tpu_torch.registry import Registrable, RegistryError


class Widget(Registrable):
    pass


@Widget.register("plain")
class Plain(Widget):
    def __init__(self, size: int = 1):
        self.size = size


@Widget.register("nested")
class Nested(Widget):
    def __init__(self, inner: Widget, name: str):
        self.inner = inner
        self.name = name


class Gadget(Registrable):
    pass


@Gadget.register("plain")
class GadgetPlain(Gadget):
    def __init__(self):
        pass


def test_by_name_and_namespacing():
    assert Widget.by_name("plain") is Plain
    assert Gadget.by_name("plain") is GadgetPlain


def test_unknown_name_raises():
    with pytest.raises(RegistryError):
        Widget.by_name("nope")


def test_from_config_flat():
    w = Widget.from_config({"type": "plain", "size": 3})
    assert isinstance(w, Plain) and w.size == 3


def test_from_config_nested_recursion():
    w = Widget.from_config(
        {"type": "nested", "name": "outer", "inner": {"type": "plain", "size": 7}}
    )
    assert isinstance(w, Nested)
    assert isinstance(w.inner, Plain) and w.inner.size == 7


def test_from_config_extras_injection():
    w = Widget.from_config({"type": "nested", "inner": {"type": "plain"}}, name="injected")
    assert w.name == "injected"


def test_missing_required_raises():
    with pytest.raises(TypeError):
        Widget.from_config({"type": "nested", "inner": {"type": "plain"}})


def test_unexpected_key_raises():
    with pytest.raises(TypeError):
        Widget.from_config({"type": "plain", "bogus": 1})


def test_duplicate_registration_raises():
    with pytest.raises(RegistryError):

        @Widget.register("plain")
        class Other(Widget):
            pass


def test_list_available():
    assert "plain" in Widget.list_available()
    assert "nested" in Widget.list_available()


def test_pep604_optional_annotation_resolved():
    @Widget.register("opt", exist_ok=True)
    class Opt(Widget):
        def __init__(self, inner: "Widget | None" = None):
            self.inner = inner

    w = Widget.from_config({"type": "opt", "inner": {"type": "plain", "size": 2}})
    assert isinstance(w.inner, Plain) and w.inner.size == 2


def test_union_prefers_registrable_arm():
    @Widget.register("uni", exist_ok=True)
    class Uni(Widget):
        def __init__(self, field: typing.Union[int, Widget] = 0):
            self.field = field

    w = Widget.from_config({"type": "uni", "field": {"type": "plain", "size": 4}})
    assert isinstance(w.field, Plain)
    w2 = Widget.from_config({"type": "uni", "field": 5})
    assert w2.field == 5


def test_port_registers_its_components_and_exports_registrable():
    assert memvul_tpu_torch.Registrable is Registrable
    assert TextTokenizer.list_available() == ["word", "wordpiece"]
    assert TextTokenizer.by_name("wordpiece") is WordPieceTokenizer
    assert TextTokenizer.by_name("word") is WordTokenizer
    assert DatasetReader.list_available() == ["reader_memory", "reader_single"]
    assert DatasetReader.by_name("reader_memory") is MemoryReader
    assert DatasetReader.by_name("reader_single") is SingleReader


# -- build_tokenizer / build_reader: the JAX package's behaviour ------------------

def _tokenizer_configs(tmp):
    vocab = tmp / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "bug",
                                "##s", "fix"]) + "\n")
    words = tmp / "words.json"
    words.write_text('{"[PAD]": 0, "[UNK]": 1, "bug": 2}')
    return {
        "default_type": {"vocab_path": str(vocab)},
        "wordpiece": {"type": "wordpiece", "vocab_path": str(vocab), "lowercase": False},
        "type_null": {"type": None, "vocab_path": str(vocab)},
        "word": {"type": "word", "vocab_path": str(words)},
        "word_inline_vocab": {"type": "word", "vocab": {"[PAD]": 0, "[UNK]": 1}},
        "unknown_type": {"type": "sentencepiece", "vocab_path": str(vocab)},
        "unexpected_key": {"type": "wordpiece", "vocab_path": str(vocab), "max_len": 64},
        "word_unexpected_key": {"type": "word", "vocab": {"a": 0}, "junk": 1},
        "no_vocab": {},
        "none": None,
    }


READER_CONFIGS = {
    "default": {},
    "none": None,
    "memory": {"type": "reader_memory", "sample_neg": 0.2, "train_iter": 2,
               "same_diff_ratio": {"same": 3, "diff": 5}},
    "single": {"type": "reader_single", "sample_neg": 0.5},
    "type_null": {"type": None},
    "unknown_type": {"type": "reader_cnn"},
    "unexpected_key": {"type": "reader_memory", "shuffle": True},
    "single_unexpected_key": {"type": "reader_single", "lazy": True},
}


def _outcome(build):
    try:
        obj = build()
    except Exception as e:  # the outcome compared is the exception itself
        return ("raises", type(e).__mro__[1:], type(e).__name__, str(e))
    return ("builds", type(obj).__name__, obj)


def _same_outcome(jax_out, port_out):
    assert jax_out[0] == port_out[0], (jax_out, port_out)
    if jax_out[0] == "raises":
        # the same exception class name and bases (RegistryError is a
        # KeyError in both) and the same message
        assert jax_out[2:] == port_out[2:]
        assert [c.__name__ for c in jax_out[1]] == [c.__name__ for c in port_out[1]]
        return
    assert jax_out[1] == port_out[1]


@pytest.mark.parametrize("case", ["default_type", "wordpiece", "type_null", "word",
                                  "word_inline_vocab", "unknown_type", "unexpected_key",
                                  "word_unexpected_key", "no_vocab", "none"])
def test_build_tokenizer_matches_jax(tmp_path, case):
    cfg = _tokenizer_configs(tmp_path)[case]
    jax_out = _outcome(lambda: jax_build.build_tokenizer(cfg))
    port_out = _outcome(lambda: port_build.build_tokenizer(cfg))
    _same_outcome(jax_out, port_out)
    if jax_out[0] == "builds":
        theirs, ours = jax_out[2], port_out[2]
        text = "The bugs fix the bug"
        assert ours.encode(text) == theirs.encode(text)
        assert ours.vocab_size == theirs.vocab_size
    if case == "unknown_type":
        assert port_out[2] == "RegistryError" and "TextTokenizer" in port_out[3]


@pytest.mark.parametrize("case", sorted(READER_CONFIGS))
def test_build_reader_matches_jax(case):
    cfg = READER_CONFIGS[case]
    jax_out = _outcome(lambda: jax_build.build_reader(cfg, seed=11))
    port_out = _outcome(lambda: port_build.build_reader(cfg, seed=11))
    _same_outcome(jax_out, port_out)
    if jax_out[0] == "builds":
        theirs, ours = jax_out[2], port_out[2]
        # the constructor's state: sampling knobs and the seeded RNG's draws
        shared = {k for k in vars(theirs) if k in vars(ours) and k != "_rng"}
        assert shared
        for key in shared:
            assert vars(ours)[key] == vars(theirs)[key], key
        if hasattr(theirs, "_rng"):
            assert ours._rng.random() == theirs._rng.random()
    if case == "unexpected_key":
        assert port_out[3] == "MemoryReader got unexpected config keys ['shuffle']"
