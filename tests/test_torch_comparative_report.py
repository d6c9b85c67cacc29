"""The port's framework-neutral copies against the JAX package's files:
evaluation/comparative_report.py on the same score files, and the m3
config templates byte for byte."""

import filecmp
import json
from pathlib import Path

import pytest

from augmentedautoencoder_tpu.evaluation import comparative_report as jax_report
from augmentedautoencoder_torch.evaluation import comparative_report as report

REPO = Path(__file__).resolve().parents[1]
M3_TEMPLATES = ["m3_template.cfg"] + sorted(
    f"cfg_m3vision/{p.name}" for p in (REPO / "augmentedautoencoder_tpu" / "cfg_templates" / "cfg_m3vision").glob("*.cfg"))


def _write_scores(root: Path):
    """Three experiments of group `grp` (one with two evals and a second
    dataset, one missing a metric, a name with LaTeX specials) and one
    experiment outside the group."""
    rows = [("exp_a", "ev1", "tless", {"vsd": 0.5, "re": 0.25}),
            ("exp_a", "ev_2", "lmo", {"vsd": 0.125}),
            ("exp_b", "ev1", "tless", {"vsd": 0.9, "re": 0.75, "add": 0.6}),
            ("c&d%", "ev1", "tless", {"te": 1.0})]
    for exp, ev, data, recalls in rows:
        d = root / "experiments" / "grp" / exp / "eval" / ev / data
        d.mkdir(parents=True)
        with open(d / "scores.json", "w") as fh:
            json.dump({m: {"recall": r, "n_correct": 1, "n_gt": 2} for m, r in recalls.items()}, fh)
    other = root / "experiments" / "other" / "exp_z" / "eval" / "ev1" / "tless"
    other.mkdir(parents=True)
    (other / "scores.json").write_text(json.dumps({"vsd": {"recall": 0.0}}))


@pytest.mark.parametrize("group", ["grp", "other", "missing"])
def test_comparative_report_matches_jax(tmp_path, group):
    _write_scores(tmp_path)
    assert report.collect_scores(str(tmp_path), group) == jax_report.collect_scores(str(tmp_path), group)
    tex = report.write_comparative_report(str(tmp_path), group, str(tmp_path / "port"))
    jtex = jax_report.write_comparative_report(str(tmp_path), group, str(tmp_path / "jax"))
    assert Path(tex).read_bytes() == Path(jtex).read_bytes()
    assert ((tmp_path / "port" / "comparative_scores.json").read_bytes()
            == (tmp_path / "jax" / "comparative_scores.json").read_bytes())
    if group == "grp":
        text = Path(tex).read_text()
        assert "c\\&d\\%" in text and "0.9000" in text and len(report.collect_scores(str(tmp_path), group)) == 4


def test_the_m3_templates_are_all_copied():
    assert len(M3_TEMPLATES) == 8
    port = sorted(p.name for p in (REPO / "augmentedautoencoder_torch" / "cfg_templates" / "cfg_m3vision").glob("*"))
    assert port == sorted(Path(n).name for n in M3_TEMPLATES[1:])


@pytest.mark.parametrize("name", M3_TEMPLATES)
def test_m3_template_is_byte_equal_to_jax(name):
    assert filecmp.cmp(REPO / "augmentedautoencoder_torch" / "cfg_templates" / name,
                       REPO / "augmentedautoencoder_tpu" / "cfg_templates" / name, shallow=False)
