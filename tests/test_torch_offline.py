"""The port's offline pipeline against the JAX package's, on the CPU:
segment folding (``models/folding.py``; and segment 0's CLS vector through
the port's encoder equal to the truncated input's, atol 1e-5 as the JAX
package's own test), every ``data/analysis.py`` function, the
``build-data`` output files and the ``analyze`` report (byte-identical to
the JAX package's CLI on the same synthetic CSV and seed), and
``selfcheck --device cpu``."""

import csv
import json

import numpy as np
import pytest
import torch

from memvul_tpu.__main__ import main as jax_main
from memvul_tpu.data import analysis as jax_analysis
from memvul_tpu.data import corpus as jax_corpus
from memvul_tpu.data import cwe as jax_cwe
from memvul_tpu.models import folding as jax_folding
from memvul_tpu_torch import __main__ as cli
from memvul_tpu_torch.data import analysis, corpus, cwe
from memvul_tpu_torch.data.synthetic import generate_corpus, research_view_records
from memvul_tpu_torch.models import folding

CLS, SEP, PAD = 2, 3, 0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- folding -------------------------------------------------------------------------


def _framed_batch(rng, batch, total, max_content):
    ids = np.full((batch, total), PAD, np.int32)
    for b in range(batch):
        n = int(rng.integers(0, max_content + 1))
        seq = [CLS] + rng.integers(10, 60, n).tolist() + [SEP]
        ids[b, : len(seq)] = seq
    return ids, (ids != PAD).astype(np.int32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_length", [6, 10, 16])
def test_fold_and_unfold_match_jax(seed, max_length):
    rng = np.random.default_rng(seed)
    ids, mask = _framed_batch(rng, batch=int(rng.integers(1, 5)), total=48, max_content=46)
    before = ids.copy(), mask.copy()
    got = folding.fold_tokens(ids, mask, max_length, CLS, SEP, PAD)
    want = jax_folding.fold_tokens(ids, mask, max_length, CLS, SEP, PAD)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    folded, fmask, s = got
    emb = rng.standard_normal((folded.shape[0], max_length, 3)).astype(np.float32)
    for mask_arg in (None, fmask):
        stream, valid = folding.unfold_embeddings(emb, s, mask_arg)
        jstream, jvalid = jax_folding.unfold_embeddings(emb, s, mask_arg)
        np.testing.assert_array_equal(stream, jstream)
        np.testing.assert_array_equal(valid, jvalid)
    # every content token survives exactly once: the valid stream count
    stream, valid = folding.unfold_embeddings(emb, s, fmask)
    assert int(valid.sum()) == int(mask.sum()) - 2 * ids.shape[0]
    # the caller's arrays are not written through
    np.testing.assert_array_equal(ids, before[0])
    np.testing.assert_array_equal(mask, before[1])


def test_fold_segment0_equals_truncation_through_the_port_encoder():
    from memvul_tpu_torch.models.bert import BertConfig, BertEncoder, init_weights

    max_length = 16
    cfg = BertConfig.tiny(vocab_size=64)
    encoder = BertEncoder(cfg).eval()
    with torch.no_grad():
        init_weights(encoder, cfg.initializer_range, generator=torch.Generator().manual_seed(0))
    tokens = [(5 + i) % 60 + 4 for i in range(40)]
    ids = np.full(48, PAD, np.int32)
    ids[: len(tokens) + 2] = [CLS] + tokens + [SEP]
    mask = (ids != PAD).astype(np.int32)
    folded, fmask, s = folding.fold_tokens(ids[None], mask[None], max_length, CLS, SEP, PAD)
    assert s > 1
    trunc = np.full((1, max_length), PAD, np.int32)
    trunc[0, : max_length - 1] = ids[: max_length - 1]
    trunc[0, max_length - 1] = SEP
    tmask = (trunc != PAD).astype(np.int32)
    np.testing.assert_array_equal(folded[0], trunc[0])
    np.testing.assert_array_equal(fmask[0], tmask[0])

    def cls_vectors(batch_ids, batch_mask):
        with torch.no_grad():
            hidden = encoder(torch.from_numpy(batch_ids).long(), torch.from_numpy(batch_mask))
        return hidden[:, 0].float().numpy()

    np.testing.assert_allclose(cls_vectors(folded, fmask)[0], cls_vectors(trunc, tmask)[0],
                               atol=1e-5, rtol=1e-5)


# -- analysis ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synthetic():
    reports, cve_dict = generate_corpus(seed=7)
    return reports, cve_dict


@pytest.mark.parametrize("text", ["possible buffer overflow in parser", "XSS in the comment field",
                                  "please fix CVE handling", "dark mode please", None, "",
                                  "Steps to reproduce: 1.", "unauthorised access", "PoCs attached"])
def test_keyword_and_attack_step_patterns_match_jax(text):
    assert analysis.matches_security_keyword(text) == jax_analysis.matches_security_keyword(text)
    assert analysis.count_attack_steps([{"Issue_Body": text}]) == \
        jax_analysis.count_attack_steps([{"Issue_Body": text}])


@pytest.mark.parametrize("stamp", ["2018-10-30 16:26:01 UTC", "2018-10-30T16:26Z", "2021-06-01",
                                   " 2020-01-02 03:04:05 UTC "])
def test_fix_timestamp_matches_jax(stamp):
    assert analysis.fix_timestamp(stamp) == jax_analysis.fix_timestamp(stamp)


def test_corpus_analyses_match_jax(synthetic):
    reports, cve_dict = synthetic
    for fn in ("keyword_match_study",):
        assert getattr(analysis, fn)(reports) == getattr(jax_analysis, fn)(reports)
    pos = analysis.join_positives_with_cve(reports, cve_dict)
    assert pos == jax_analysis.join_positives_with_cve(reports, cve_dict)
    assert analysis.count_attack_steps(pos) == jax_analysis.count_attack_steps(pos)
    for cves in (cve_dict, None):
        assert analysis.delta_days_histogram(pos, cves) == \
            jax_analysis.delta_days_histogram(pos, cves)
    tree = cwe.build_cwe_tree(research_view_records())
    for t in (tree, None, {}):
        dist = analysis.cwe_report_distribution(pos, t)
        assert dist == jax_analysis.cwe_report_distribution(pos, t)
        assert analysis.cumulative_cwe_distribution(dist) == \
            jax_analysis.cumulative_cwe_distribution(dist)
    repo_info = {f"org{i}/repo{i}": {"stargazers_count": 10 * (i + 1), "watchers_count": 5,
                                     "forks_count": i, "subscribers_count": 1} for i in range(7)}
    assert analysis.repo_stats(reports, repo_info) == jax_analysis.repo_stats(reports, repo_info)


def test_analysis_edge_cases_match_jax():
    special = [{"CVE_ID": "CVE-1", "CWE_ID": "NVD-CWE-noinfo"}, {"CVE_ID": "CVE-2", "CWE_ID": None},
               {"CVE_ID": "CVE-2", "CWE_ID": None}]
    assert analysis.cwe_report_distribution(special, {}) == \
        jax_analysis.cwe_report_distribution(special, {})
    assert analysis.cumulative_cwe_distribution({}) == []
    positives = [
        {"Issue_Created_At": "2021-06-01T00:00:00Z", "Published_Date": "2021-06-01T00:00Z"},
        {"Issue_Created_At": "2021-06-01T00:00:00Z", "Published_Date": "2021-06-04T00:00Z"},
        {"Issue_Created_At": "2021-01-01T00:00:00Z", "Published_Date": "2021-07-20T00:00Z"},
        {"Issue_Created_At": "2021-06-01T00:00:00Z", "CVE_ID": "CVE-missing"},
        {"Issue_Created_At": "", "Published_Date": "2021-07-20"},
    ]
    hist = analysis.delta_days_histogram(positives, {"CVE-1": {}})
    assert hist == jax_analysis.delta_days_histogram(positives, {"CVE-1": {}})
    assert hist["counts"] == [1, 1, 0, 0, 1]
    with pytest.raises(ValueError):
        analysis.delta_days_histogram([{"Issue_Created_At": "yesterday",
                                        "Published_Date": "2021-01-01"}])


# -- build-data and analyze ----------------------------------------------------------


@pytest.fixture(scope="module")
def raw_inputs(tmp_path_factory, synthetic):
    tmp = tmp_path_factory.mktemp("raw")
    # 24 projects: the 10% project-level splits are non-empty
    reports, cve_dict = generate_corpus(seed=9, num_projects=24)
    csv_path = tmp / "all_samples.csv"
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(reports[0].keys()))
        writer.writeheader()
        writer.writerows(reports)
    cve_path = tmp / "CVE_dict.json"
    cve_path.write_text(json.dumps(cve_dict))
    cwe_path = tmp / "1000.csv"
    records = research_view_records()
    with open(cwe_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(records[0].keys()))
        writer.writeheader()
        writer.writerows(records)
    return {"csv": csv_path, "cve": cve_path, "cwe": cwe_path, "tmp": tmp}


BUILD_FILES = ("train_project.json", "validation_project.json", "test_project.json",
               "train_project_mlm.txt", "CWE_anchor_golden_project.json",
               "CWE_anchor_full_view.json")


@pytest.mark.parametrize("extra", [[], ["--seed", "7"], ["--full-view-anchors"], ["no-cwe"]])
def test_build_data_matches_jax(raw_inputs, tmp_path, capsys, extra):
    args = ["build-data", "--csv", str(raw_inputs["csv"]), "--cve-dict", str(raw_inputs["cve"])]
    if extra != ["no-cwe"]:
        args += ["--cwe-csv", str(raw_inputs["cwe"]), *extra]
    assert cli.main(args + ["--out", str(tmp_path / "port")]) == 0
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_main(args + ["--out", str(tmp_path / "jax")]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mine == theirs and mine["train"] and mine["test"] and mine["mlm_lines"]
    made = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == made
    assert set(made) <= set(BUILD_FILES) and "train_project_mlm.txt" in made
    for name in made:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_build_data_refuses_full_view_without_the_cwe_csv(raw_inputs, tmp_path, capsys):
    assert cli.main(["build-data", "--csv", str(raw_inputs["csv"]), "--out", str(tmp_path),
                     "--full-view-anchors"]) == 2
    assert "--cwe-csv" in capsys.readouterr().err


def test_corpus_and_cwe_helpers_match_jax(raw_inputs, tmp_path, synthetic):
    reports, cve_dict = synthetic
    clean = corpus.preprocess(reports)
    assert corpus.write_mlm_corpus(clean, tmp_path / "a.txt") == \
        jax_corpus.write_mlm_corpus(clean, tmp_path / "b.txt")
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
    records = cwe.load_research_view_csv(raw_inputs["cwe"])
    assert records == jax_cwe.load_research_view_csv(raw_inputs["cwe"])
    tree = cwe.build_cwe_tree(records)
    for seed in (0, 5):
        assert cwe.build_full_view_anchors(tree, cve_dict, None, seed=seed) == \
            jax_cwe.build_full_view_anchors(jax_cwe.build_cwe_tree(records), cve_dict, None,
                                            seed=seed)


@pytest.mark.parametrize("flags", [["cve"], [], ["cve", "repo"]])
def test_analyze_matches_jax(raw_inputs, tmp_path, capsys, flags):
    cli.main(["build-data", "--csv", str(raw_inputs["csv"]), "--cve-dict", str(raw_inputs["cve"]),
              "--cwe-csv", str(raw_inputs["cwe"]), "--out", str(tmp_path / "data")])
    capsys.readouterr()
    args = ["analyze", str(tmp_path / "data" / "train_project.json")]
    if "cve" in flags:
        args += ["--cve-dict", str(raw_inputs["cve"])]
    if "repo" in flags:
        repo = tmp_path / "repo_info.json"
        repo.write_text(json.dumps({f"org{i}/repo{i}": {"stargazers_count": i} for i in range(5)}))
        args += ["--repo-info", str(repo)]
    assert cli.main(args + ["-o", str(tmp_path / "port.json")]) == 0
    mine = capsys.readouterr().out
    assert jax_main(args + ["-o", str(tmp_path / "jax.json")]) == 0
    theirs = capsys.readouterr().out
    assert mine == theirs
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    report = json.loads(mine)
    assert report["num_samples"] == sum(report["keyword_match"].values()) > 0
    if "cve" in flags:
        assert report["delta_days"]["total"] > 0
        assert report["cwe_cumulative"][-1][1] == pytest.approx(1.0)


# -- selfcheck -----------------------------------------------------------------------


def test_selfcheck_on_the_cpu(tmp_path, capsys):
    rc = cli.main(["selfcheck", "--dir", str(tmp_path / "sc"), "--reports", "12",
                   "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["selfcheck"] == "ok", report
    assert report["device"] == "cpu" and report["missing_metric_keys"] == []
    assert all(report["splits"].values())
    m = report["metrics"]
    assert m["TP"] + m["FN"] + m["TN"] + m["FP"] == report["splits"]["test"]
    assert (tmp_path / "sc" / "eval" / "selfcheck_metric_all.json").exists()


def test_selfcheck_default_device_refuses_a_host_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["selfcheck", "--dir", str(tmp_path / "sc")])
    assert not (tmp_path / "sc").exists()
