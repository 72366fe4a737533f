"""The port's native normalizer (``memvul_tpu_torch/native/normalizer.cpp``
through ``memvul_tpu_torch/data/native.py``) against the JAX package's
normalizer, on the CPU.

The Python pass table is the specification; the library must agree with
it byte for byte, and with the JAX package's ``normalize_text`` and
native ``normalize_batch``, or be disabled by its own checks.  The 11
cases of ``tests/test_native_normalizer.py`` run against the port, each
restoring the module state it touches (the ``_lib`` / ``_state`` /
``_reason`` / ``_kind`` globals), so no test leaves the native path off
for a later one.
"""

import pytest

from memvul_tpu.data import native as jax_native
from memvul_tpu.data.normalize import normalize_text as jax_normalize_text
from memvul_tpu_torch.data import native
from memvul_tpu_torch.data.native import _native_one, get_native_normalizer, normalize_batch
from memvul_tpu_torch.data.normalize import normalize_text
from memvul_tpu_torch.data.synthetic import corpus_texts, generate_corpus

ADVERSARIAL = [
    "",
    " ",
    "CVE-2021-44228 CWE-79 CVE-1-2",
    "https://cve.mitre.org/data?x=1 http://bugzilla.redhat.com/123",
    "https://example.com/a.zip https://example.com/index",
    "[link](a/b/c.md) ![img](http://x.com/i.png) [t](http://y.com)",
    "``` erro```r``` fine ```",
    "`` `` ` ` ``````",
    "nested `outer ```inner``` outer` end",
    "a@b.com someone_longer@domain.net x@y.cn @mention ",
    "Main.java:42 NullPointerException(foo) IOError: bad",
    "/a/b/c d\\e\\f g/h win\\path\\x.txt",
    "v1.2.3 2021-01-01 1e10 0x1F beta7 1.0.0-beta3",
    "thisIsCamel ALLCAPS lower.dotted.name call() arr[]",
    "<html><body> <<>> <a href=\"x\"> <-> < >",
    "-- --- ---- -",
    "####title *bold* **x** \\n\\n \\r\\n \\t\\t",
    "x" * 29, "y" * 30, "z" * 151,
    "word " * 200,
    "yaml\nfoo: bar\nbaz: qux",
    "Traceback (most recent call last):\n  File \"x.py\", line 1",
    "ünïcode naïve café — em-dash…",
    "tab\there newline\nhere cr\rhere",
]


@pytest.fixture(autouse=True)
def native_state():
    """Every test starts from the validated library and leaves the module
    globals as it found them."""
    saved = (native._lib, native._state, native._reason, native._kind)
    assert native.native_available(), native.native_status()
    yield
    native._lib, native._state, native._reason, native._kind = saved


def test_parity_on_adversarial_battery():
    lib = get_native_normalizer()
    for doc in ADVERSARIAL:
        out = _native_one(lib, doc)
        if out is None:
            continue  # explicit fallback is allowed, silence is not
        assert out == normalize_text(doc), f"divergence on {doc[:60]!r}"
        assert out == jax_normalize_text(doc), f"divergence from the JAX package on {doc[:60]!r}"


def test_parity_on_synthetic_corpus():
    reports, _ = generate_corpus(seed=13, num_projects=6, reports_per_project=30)
    texts = corpus_texts(reports)
    out = normalize_batch(texts)
    assert out == [normalize_text(t) for t in texts]
    assert out == jax_native.normalize_batch(texts)


def test_batch_matches_single_calls_and_the_jax_package():
    assert normalize_batch(ADVERSARIAL) == [normalize_text(d) for d in ADVERSARIAL]
    assert normalize_batch(ADVERSARIAL) == jax_native.normalize_batch(ADVERSARIAL)
    assert normalize_batch(ADVERSARIAL) == [jax_normalize_text(d) for d in ADVERSARIAL]


def test_force_python_path():
    docs = ["CVE-2020-1 check"]
    assert normalize_batch(docs, force_python=True) == [normalize_text(docs[0])]


def test_non_ascii_doc_falls_back_natively():
    doc = "@user\xa0hello there"
    assert _native_one(get_native_normalizer(), doc) is None
    assert normalize_batch([doc]) == [normalize_text(doc)]


def test_nul_byte_doc_falls_back():
    doc = "abc\x00hidden error text here"
    assert _native_one(get_native_normalizer(), doc) is None
    assert normalize_batch([doc]) == [normalize_text(doc)]


def test_corrupt_library_disables_native(tmp_path, monkeypatch):
    bad = tmp_path / "libmemvul_native_bad.so"
    bad.write_bytes(b"not a shared object")
    monkeypatch.setattr(native, "_build_library", lambda: bad)
    assert native._load() is None
    # and the status says why, by kind
    native._state = native._lib = native._reason = native._kind = None
    assert native.get_native_normalizer() is None
    assert native.native_status()["kind"] == "load_failed"


def test_oversized_doc_falls_back():
    lib = get_native_normalizer()
    big = "word " * 4_000  # 20KB > the 16KB single-document cap
    assert _native_one(lib, big) is None
    huge = "word " * 60_000  # 300KB > the 256KB batch cap
    out = normalize_batch([big, huge, "small CVE-2021-2 doc"])
    assert out[0] == normalize_text(big)
    assert out[1] == normalize_text(huge)
    assert out[2] == normalize_text("small CVE-2021-2 doc")


def test_caller_stack_cap_boundary():
    """Documents at the 16KB single-document boundary: just below is
    normalized natively (the same bytes as the JAX package's library, whose
    own suite holds it to the Python specification at this size), just
    above returns NULL and Python answers."""
    lib = get_native_normalizer()
    under = "a" * 20 + " word" * ((16 << 10) // 5 - 10)
    assert len(under.encode()) <= 16 << 10
    got = _native_one(lib, under)
    assert got is not None
    assert got == jax_native._native_one(jax_native.get_native_normalizer(), under)
    # one byte over the cap, in words (a single 16KB token costs the Python
    # specification seconds, and the batch path's sampled check runs it)
    over = "c " * (8 << 10) + "d"
    assert len(over.encode()) == (16 << 10) + 1
    assert _native_one(lib, over) is None
    assert normalize_batch([over]) == [normalize_text(over)]


def test_sampled_runtime_parity_disables_on_mismatch(monkeypatch):
    monkeypatch.setattr(native, "_sampled_parity_ok", lambda *a: False)
    docs = ["CVE-2021-44228 here", "plain words"]
    assert native.normalize_batch(docs) == [normalize_text(d) for d in docs]
    assert not native.native_available()  # disabled for the process
    assert native.native_status()["kind"] == "runtime_parity_failed"
    # the fixture restores the validated library for the next test


def test_preprocess_uses_batch_path(monkeypatch):
    from memvul_tpu_torch.data.corpus import preprocess

    calls = []
    real = native.normalize_batch
    monkeypatch.setattr(native, "normalize_batch",
                        lambda texts, **kw: calls.append(len(texts)) or real(texts, **kw))
    reports, _ = generate_corpus(seed=3, num_projects=2, reports_per_project=10)
    raw_titles = {r["Issue_Url"]: r["Issue_Title"] for r in reports}
    clean = preprocess(reports)
    assert calls == [len(clean), len(clean)]  # titles, then bodies, one batch each
    for rec in clean:
        assert rec["Issue_Title"] == normalize_text(raw_titles[rec["Issue_Url"]])


def test_env_optout_and_status_kinds(monkeypatch):
    monkeypatch.setenv("MEMVUL_NATIVE", "0")
    native._state = native._lib = native._reason = native._kind = None
    assert native.native_status() == {"state": "disabled",
                                      "reason": "MEMVUL_NATIVE=0 (env opt-out)",
                                      "kind": "env_optout"}
    assert normalize_batch(["CVE-2020-1 x"]) == [normalize_text("CVE-2020-1 x")]


def test_library_is_keyed_by_the_source_hash(monkeypatch, tmp_path):
    """The build lands in build/native/ under a name carrying the source's
    hash; a finished build is reused, an edited source builds anew."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "native")
    assert path.exists() and native._build_library() == path
    src = tmp_path / "normalizer.cpp"
    src.write_text(native._SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "_SOURCE", src)
    assert native.library_path() != path
