"""End-to-end CLI workflow on the seeded fixture panel (in-process: the CLI
is plain argparse over the library, so subprocesses are unnecessary)."""

import gzip
import json

import numpy as np
import pytest

from _panel import MODEL_CLASSIFIERS
from hibag_tpu.cli import main


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, model_list, hapmap_geno):
    """The fixture model as a HIBAG ModelList.RData and the panel's
    genotypes as .npz, the CLI's two input formats."""
    from hibag_tpu.cli import save_geno
    from hibag_tpu.models.model import AttrBagModel
    from hibag_tpu.models.publish import save_rdata
    d = tmp_path_factory.mktemp("cli")
    save_rdata({"A": AttrBagModel.from_hibag_obj(model_list["A"],
                                                 locus="A")},
               str(d / "ModelList.RData"))
    save_geno(hapmap_geno, str(d / "panel.npz"))
    return d


def test_cli_convert_model_and_geno(workdir):
    assert main(["convert", str(workdir / "ModelList.RData"),
                 str(workdir / "modelA.npz"), "--locus", "A"]) == 0
    assert main(["convert", str(workdir / "panel.npz"),
                 str(workdir / "geno.npz"), "--geno"]) == 0
    from hibag_tpu.models.model import AttrBagModel
    m = AttrBagModel.load(str(workdir / "modelA.npz"))
    assert m.n_classifiers == MODEL_CLASSIFIERS and m.locus == "A"
    # and back out to R (npz -> .RData, hlaModelFromObj-loadable)
    assert main(["convert", str(workdir / "modelA.npz"),
                 str(workdir / "modelA.RData")]) == 0
    from hibag_tpu.io.rdata import read_rdata, r_to_py
    back = AttrBagModel.from_hibag_obj(
        r_to_py(read_rdata(str(workdir / "modelA.RData"))["mobj"]),
        locus="A")
    assert back.n_classifiers == MODEL_CLASSIFIERS


def test_cli_impute_tsv_and_vcf(workdir, capsys):
    out = workdir / "calls.tsv"
    assert main(["impute", "--model", str(workdir / "modelA.npz"),
                 "--geno", str(workdir / "geno.npz"),
                 "--out", str(out), "--match-type", "RefSNP"]) == 0
    lines = out.read_text().splitlines()
    assert lines[0].split("\t") == ["sample.id", "allele1", "allele2",
                                    "prob", "matching"]
    assert len(lines) == 61                 # header + 60 samples
    a1 = lines[1].split("\t")
    assert ":" in a1[1] and 0 < float(a1[3]) <= 1

    vout = workdir / "calls.vcf.gz"
    assert main(["impute", "--model", str(workdir / "modelA.npz"),
                 "--geno", str(workdir / "geno.npz"),
                 "--out", str(vout), "--match-type", "RefSNP"]) == 0
    text = gzip.open(vout, "rt").read()
    assert text.startswith("##fileformat=VCF")


def test_cli_summary(workdir, capsys):
    assert main(["summary", str(workdir / "modelA.npz")]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["num.classifier"] == MODEL_CLASSIFIERS and s["locus"] == "A"


def test_cli_train_and_report(workdir, capsys, hla_types):
    # truth table as TSV (HLA_Type_Table layout)
    tsv = workdir / "truth.tsv"
    with open(tsv, "w") as f:
        f.write("sample.id\tA.1\tA.2\n")
        for s, a1, a2 in zip(hla_types["sample.id"], hla_types["A.1"],
                             hla_types["A.2"]):
            f.write(f"{s}\t{a1}\t{a2}\n")
    geno_npz = workdir / "panel.npz"

    model_out = workdir / "trained.npz"
    assert main(["train", "--hla", str(tsv), "--geno", str(geno_npz),
                 "--locus", "A", "--out", str(model_out),
                 "--n-classifiers", "4", "--quiet"]) == 0
    from hibag_tpu.models.model import AttrBagModel
    m = AttrBagModel.load(str(model_out))
    assert m.n_classifiers == 4

    calls = workdir / "self.tsv"
    assert main(["impute", "--model", str(model_out),
                 "--geno", str(geno_npz), "--out", str(calls)]) == 0
    capsys.readouterr()
    assert main(["report", "--pred", str(calls), "--truth", str(tsv),
                 "--locus", "A", "--format", "md"]) == 0
    rep = capsys.readouterr().out
    assert "accuracy" in rep.lower() or "|" in rep


def test_cli_impute_stdout_not_closed(workdir, capsys):
    """--out - writes the table to stdout WITHOUT closing it (a closed
    sys.stdout breaks every later print in the process)."""
    import sys

    assert main(["impute", "--model", str(workdir / "modelA.npz"),
                 "--geno", str(workdir / "geno.npz"),
                 "--out", "-", "--match-type", "RefSNP"]) == 0
    assert not sys.stdout.closed
    out = capsys.readouterr().out
    assert out.startswith("sample.id\t")
    print("still alive")          # would raise if stdout were closed
