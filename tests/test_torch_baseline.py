"""The port's classical baselines against scikit-learn 1.9 (an oracle on
this host only; the port never imports it).

On a seeded synthetic bag-of-words corpus (Zipf vocabulary, a noisy linear
label, unicode and punctuation texts):

* ``CountVectorizer``: the vocabulary and counts exactly equal;
* the L1 SVC: its primal objective at the port's weights no more than 1e-3
  (relative) above liblinear's, the selected support's Jaccard reported;
* downstream learners are held on sklearn's selected matrix, so a
  selection difference does not compound: NB's predictions equal and its
  probabilities within 1e-9; KNN's predictions equal wherever no distance
  tie straddles the 5th neighbour (the ties are counted); LR's
  probabilities within 1e-3 of the converged sklearn fit and its
  objective no worse than sklearn's default stopping point; RF and MLP
  reproduce themselves for one seed and land within 0.1 AUC of sklearn's.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier
from sklearn.feature_extraction.text import CountVectorizer
from sklearn.linear_model import LogisticRegression
from sklearn.metrics import roc_auc_score
from sklearn.naive_bayes import MultinomialNB
from sklearn.neighbors import KNeighborsClassifier
from sklearn.neural_network import MLPClassifier
from sklearn.svm import LinearSVC

from memvul_tpu.baselines.sklearn_baseline import run_baselines as jax_run_baselines
from memvul_tpu_torch import __main__ as cli
from memvul_tpu_torch.baselines import sklearn_baseline as bl
from memvul_tpu_torch.baselines.stop_words import ENGLISH_STOP_WORDS

C_SVC = bl.SVC_C
LEARNERS = ("RF", "NB", "MLP", "LR", "KNN")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corpus(n, seed, vocab=1000):
    rng = np.random.default_rng(seed)
    words = [f"w{i}x" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    signal_rng = np.random.default_rng(1234)  # the same signal words for every split
    signal = signal_rng.choice(np.arange(20, 600), 25, replace=False)
    weight = signal_rng.normal(0, 2.5, 25)
    extras = [" Ünïcödé déjà-vu, The AND of it! 42 x1 __init__ naïve",
              " CVE-2021-1234: buffer-overflow in libfoo/bar.c (see https://x.io/a?b=c)",
              " 中文 字符 mixed_with_ascii ΑΒΓ αβγ", ""]
    docs, labels = [], []
    for i in range(n):
        ids = rng.choice(vocab, int(np.clip(rng.lognormal(3.0, 0.8), 3, 200)), p=p)
        score = sum(w for s, w in zip(signal, weight) if s in ids) - 0.5 + rng.normal(0, 0.5)
        docs.append(" ".join(words[j] for j in ids) + extras[i % len(extras)])
        labels.append(int(score > 0))
    return docs, np.asarray(labels)


@pytest.fixture(scope="module")
def data():
    train_docs, y_train = _corpus(600, 0)
    test_docs, y_test = _corpus(200, 1)
    sk_vec = CountVectorizer(stop_words="english")
    x_train, x_test = sk_vec.fit_transform(train_docs), sk_vec.transform(test_docs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc = LinearSVC(penalty="l1", C=C_SVC, dual=False, random_state=2021).fit(x_train, y_train)
    support = np.abs(svc.coef_[0]) >= 1e-5
    return dict(train_docs=train_docs, test_docs=test_docs, y_train=y_train, y_test=y_test,
                sk_vec=sk_vec, x_train=x_train, x_test=x_test, svc=svc, support=support,
                sel_train=x_train[:, support], sel_test=x_test[:, support])


def test_stop_words_are_sklearns_318():
    from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS as SK

    assert len(ENGLISH_STOP_WORDS) == 318 and ENGLISH_STOP_WORDS == SK


def test_vectorizer_vocabulary_and_counts_equal(data):
    vec = bl.CountVectorizer()
    x_train = vec.fit_transform(data["train_docs"])
    x_test = vec.transform(data["test_docs"])
    assert vec.vocabulary_ == data["sk_vec"].vocabulary_
    assert any(not term.isascii() for term in vec.vocabulary_)  # unicode terms counted
    for got, want in ((x_train, data["x_train"]), (x_test, data["x_test"])):
        assert got.shape == want.shape and got.dtype == want.dtype == np.int64
        assert (got != want).nnz == 0
    with pytest.raises(ValueError, match="empty vocabulary"):
        bl.CountVectorizer().fit_transform(["the and of", "a"])


def _svc_objective(x, y, coef, intercept):
    margin = np.maximum(0.0, 1.0 - (2 * y - 1) * (x @ coef + intercept))
    return np.abs(coef).sum() + abs(intercept) + C_SVC * (margin ** 2).sum()


def test_l1_svc_objective_within_1e3_of_liblinear(data):
    coef, intercept = bl.l1_svc(data["x_train"], data["y_train"], device="cpu")
    want = _svc_objective(data["x_train"], data["y_train"], data["svc"].coef_[0],
                          data["svc"].intercept_[0])
    got = _svc_objective(data["x_train"], data["y_train"], coef, intercept)
    assert got <= want * (1 + 1e-3)
    support = bl.select_features(coef)
    jaccard = (support & data["support"]).sum() / (support | data["support"]).sum()
    print(f"L1-SVC: objective {got:.6f} vs liblinear {want:.6f}, support {support.sum()} vs "
          f"{data['support'].sum()}, Jaccard {jaccard:.4f}")
    assert 0 < support.sum() < len(support) and jaccard >= 0.9


def test_multinomial_nb_predictions_equal(data):
    sk = MultinomialNB().fit(data["sel_train"], data["y_train"])
    port = bl.MultinomialNB(device="cpu").fit(data["sel_train"], data["y_train"])
    np.testing.assert_array_equal(port.predict(data["sel_test"]), sk.predict(data["sel_test"]))
    np.testing.assert_allclose(port.predict_proba(data["sel_test"]),
                               sk.predict_proba(data["sel_test"]), rtol=0, atol=1e-9)


def test_knn_predictions_equal_off_the_ties(data):
    x_train, x_test = data["sel_train"], data["sel_test"]
    sk = KNeighborsClassifier().fit(x_train, data["y_train"])
    port = bl.KNeighborsClassifier(tile=64, device="cpu").fit(x_train, data["y_train"])
    dist = (np.asarray(x_test.multiply(x_test).sum(1)) + np.asarray(x_train.multiply(x_train).sum(1)).T
            - 2 * (x_test @ x_train.T).toarray())
    fifth = np.sort(dist, axis=1)[:, 4]
    tied = (dist <= fifth[:, None]).sum(axis=1) > 5
    print(f"KNN: {int(tied.sum())} of {len(tied)} test rows have a tie at the 5th neighbour")
    assert (~tied).sum() >= 20
    got, want = port.predict(x_test), sk.predict(x_test)
    np.testing.assert_array_equal(got[~tied], want[~tied])
    # the port's neighbours: nearest first, ties towards the lower training index
    d, idx = port.kneighbors(x_test)
    np.testing.assert_allclose(d, np.sort(dist, axis=1)[:, :5], atol=1e-9)
    for row in range(len(idx)):
        order = np.lexsort((np.arange(dist.shape[1]), dist[row]))[:5]
        np.testing.assert_array_equal(idx[row], order)


def _lr_objective(x, y, coef, intercept):
    z = x @ coef + intercept
    return np.logaddexp(0.0, -(2 * y - 1) * z).sum() + 0.5 * coef @ coef


def test_logistic_regression_probabilities_within_1e3(data):
    x_train, x_test, y = data["sel_train"], data["sel_test"], data["y_train"]
    port = bl.LogisticRegression(device="cpu").fit(x_train, y)
    default = LogisticRegression(max_iter=1000, random_state=2021).fit(x_train, y)
    converged = LogisticRegression(max_iter=10000, tol=1e-10, random_state=2021).fit(x_train, y)
    p_port = port.predict_proba(x_test)[:, 1]
    p_sk = converged.predict_proba(x_test)[:, 1]
    assert np.abs(p_port - p_sk).max() <= 1e-3
    clear = np.abs(p_sk - 0.5) > 1e-3
    np.testing.assert_array_equal(port.predict(x_test)[clear], converged.predict(x_test)[clear])
    got = _lr_objective(x_train, y, port.coef_.numpy(), float(port.intercept_))
    assert got <= _lr_objective(x_train, y, default.coef_[0], default.intercept_[0]) + 1e-9
    print(f"LR: max |p - sklearn default| {np.abs(p_port - default.predict_proba(x_test)[:, 1]).max():.2e}")


@pytest.mark.parametrize("name", ["RF", "MLP"])
def test_random_learners_are_seeded_and_near_sklearn(data, name):
    x_train, x_test, y = data["sel_train"], data["sel_test"], data["y_train"]
    make = {"RF": lambda: bl.RandomForestClassifier(seed=2021),
            "MLP": lambda: bl.MLPClassifier(seed=2021, device="cpu")}[name]
    first = make().fit(x_train, y).predict_proba(x_test)
    again = make().fit(x_train, y).predict_proba(x_test)
    np.testing.assert_array_equal(first, again)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = (RandomForestClassifier(n_estimators=30, oob_score=True, random_state=2021)
              if name == "RF" else MLPClassifier(max_iter=10, random_state=2021))
        sk.fit(x_train, y)
    got = roc_auc_score(data["y_test"], first[:, 1])
    want = roc_auc_score(data["y_test"], sk.predict_proba(x_test)[:, 1])
    print(f"{name}: AUC {got:.4f} vs sklearn {want:.4f}")
    assert abs(got - want) <= 0.1
    if name == "RF":
        rf = make().fit(x_train, y)
        assert 0.5 < rf.oob_score_ <= 1.0


def _reports(docs, labels, split):
    return [{"Issue_Url": f"https://github.com/o/r/issues/{split}{i}",
             "Issue_Title": doc.split(" ", 1)[0], "Issue_Body": doc.split(" ", 1)[-1],
             "Security_Issue_Full": str(int(label))} for i, (doc, label) in
            enumerate(zip(docs, labels))]


def test_run_baselines_writes_the_reference_files_and_the_cli(data, tmp_path, capsys):
    train, test = tmp_path / "train.json", tmp_path / "test.json"
    train.write_text(json.dumps(_reports(data["train_docs"], data["y_train"], "a")))
    test.write_text(json.dumps(_reports(data["test_docs"], data["y_test"], "b")))
    assert cli.main(["baseline", str(train), str(test), "-o", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(metrics) == list(LEARNERS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_run_baselines(train, test, tmp_path / "jax")
    written = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert written == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(written) == 10
    for name in LEARNERS:
        got = json.loads((tmp_path / "port" / f"{name}_metric.json").read_text())
        assert set(got) == set(want[name]) and got == metrics[name]
        records = json.loads((tmp_path / "port" / f"{name}_result.json").read_text())
        ref = json.loads((tmp_path / "jax" / f"{name}_result.json").read_text())
        assert [r["Issue_Url"] for r in records] == [r["Issue_Url"] for r in ref]
        assert set(records[0]) == set(ref[0]) == {"Issue_Url", "label", "predict", "prob"}
    # NB is deterministic and exact on either side of the selection, once
    # both selected the same features
    assert metrics["NB"]["TP"] + metrics["NB"]["FN"] == want["NB"]["TP"] + want["NB"]["FN"]


def test_baseline_entry_point_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    (tmp_path / "c.json").write_text("[]")
    with pytest.raises(RuntimeError, match="CUDA"):
        bl.run_baselines(tmp_path / "c.json", tmp_path / "c.json", tmp_path / "out")
